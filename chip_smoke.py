"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase (what the check runs)
    python3 chip_smoke.py --kernels-only  # build + kernel phase only

Phases, each fatal on failure (nothing is caught). Phase 4's runs other
than freekv/none, and phases 4b, 4c and 4d, run their models at full width
and half depth (half the periods, ``half_depth``): they are host-bound, so
their time is linear in the layers.
  1. device: the card's name and power limit from nvidia-smi, its PCIe link
     (generation and width from nvidia-smi and sysfs, "not readable" where
     the machine hides them) and NUMA node; exits non-zero without CUDA.
  2. build: the six CUDA sources (thirteen kernel entry points) from this
     checkout, one nvcc per source, in parallel.
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes (B=4, kv=8, G=4, H=32, d=128, p=32, n_sel=56,
     L=2080, T=8192, the 259 pages of an 8192-token context, C=16
     clusters), in bfloat16 and float32, with the tolerances of TOL: the
     gathers (recall_gather and recall_values; recall_gather_quant and
     recall_values_quant at int8 and int4, groups 0/16/32) exact from a
     device pool and from a pinned host pool, page_summary (the
     summary-only entry) and fill_pages (summaries, HND block and scales in
     one pass; fp, int8 and int4; the prefill into a pinned pool equal to
     it into a device pool) exact and flash_prefill within TOL at a
     continuous admission's shapes (B=1, T=8192 and 7168; timed at B=1,
     T=8192) and at the static batch's (B=4, T=8192; timed beside it),
     flash_prefill also with a sliding-window case and a softcap case, and
     in its extension form (Tq query rows over Tk >= Tq keys, the causal
     mask aligned bottom-right) at Tq/Tk = 2048/8192, 1000/7200, 1/4096, a
     windowed and a softcapped case, timed at 2048/8192 beside its bound and
     SDPA with a lower-right causal bias;
     complete_page exact to a device and to a pinned pool over 4 slots with
     no row, some rows and every row completing a page (also over a ring
     where the page wraps), a row that completes nothing byte-identical,
     timed to the pinned pool with every row and with no row completing;
     fill_pages and complete_page each beside the composition it replaced,
     centroid_scores within 2e-5 with empty clusters at exactly -1e30;
     select_pages (scores, mask, group pooling and top-k in one launch) with
     page ids exactly equal on far-apart, forced-tie and underflow inputs in
     every pooling mode (also at 32768 pages, where a block's scores go to a
     workspace), tie-aware on random inputs, exact with -1 candidates, and
     pooled scores within 2e-5; centroid_candidates with candidate ids
     exactly equal; each also timed beside the composition it replaced (the
     scoring kernel plus the PyTorch ops around it); device times of the kernel, its plain version and one PyTorch call that
     computes the same function (a yardstick the port never calls), beside
     the bound; for the two attention kernels also the yardstick's own
     max |error| against the plain version and whether it is within TOL.
     The host-pool gathers are timed cycling four selections with disjoint
     pages (the card's L2 keeps system-memory reads), beside the link's
     ceiling: one contiguous copy_ of the same bytes from pinned memory,
     and each logs the grid it launches from a pinned and from a device pool.
     Then the kernels at the other served archs' shapes (ARCH_SHAPES:
     qwen25-7b G=7 d=128 kv=4, smollm-360m G=3 d=64 kv=5, gemma2-2b G=2
     d=256 kv=4 with softcap 50 and window 4096, stablelm-3b G=1 d=80
     kv=32, deepseek-moe-16b G=1 d=128 kv=16, llama4-scout-17b-a16e G=5
     d=128 kv=8, jamba-1.5-large-398b G=8 d=128 kv=8, whisper-tiny G=1 d=64
     kv=6, internvl2-26b G=6 d=128 kv=8, and TP_SHAPES, the shard layout of
     phase 4f: llama31-8b@tp2 G=4 d=128 kv=4): paged_attention at
     each decode shape and flash_prefill at each
     admission (B=1, T=8192) and extension (2048 over 8192) within TOL
     (not at TP_SHAPES: the backbone prefills at the whole arch's heads),
     fp32 and bf16 (d=80 on the d=128 tiles, channels past 80 zero);
     select_pages' per-query-head mode (Quest) and the pooled mode at each
     G, ids exact on far-apart, forced-tie and invalid-lane inputs (the
     invalid lanes keeping jax.lax.top_k's ids), tie-aware on random ones;
     fill_pages and complete_page exact at d=80 and 256 and at the five
     newer archs' KV heads and at TP_SHAPES'; recall_gather exact at
     TP_SHAPES from a device and a pinned pool; each timed at bf16
     (flash_prefill in both forms, select_pages in both modes) beside its
     bound, its plain version and SDPA where SDPA computes the same
     function. flash_prefill's bidirectional form (causal=False, an
     encoder's) within TOL at whisper-tiny's encoder shape (6/6 heads, d 64,
     T=1500 and 1536, B=1 and 4), timed beside its bound, the plain version
     and SDPA without a mask (and SDPA's own max |error|).
 3b. the MoE FFN and the Mamba mixer at full width (torch ops; they replace
     no TPU kernel, so their numbers go on [moe] and [ssm] lines): one
     deepseek-moe-16b MoE layer (64 experts of 2048 x 1408, top-6, 2 shared)
     with seeded weights and a router biased so that capacity binds at 8
     and 1024 tokens: at float32 apply_moe within 1e-4 of the
     capacity-aware dense oracle at N = 4, 8 and 1024; at bfloat16 bit-equal
     outputs run twice at N = 4 and 8192; a call at N = 4 under
     torch.cuda.set_sync_debug_mode("error"); device ms at N = 4 and 8192
     beside two bounds, the reference design's (all 64 experts at capacity
     C) and the routed experts' own. One jamba-1.5-large-398b Mamba layer
     (d 8192, d_inner 16384, d_state 16): at float32 256 decode steps
     chained from the empty state within 1e-4 of mamba_forward's outputs
     and final state (the largest error logged); a decode step at B = 4
     under sync debug mode "error"; device ms of a decode step at B = 4 and
     of a prefill at T = 2048 beside their bounds. One xlstm-350m mLSTM and
     one sLSTM layer (d 1024, 4 heads, d_inner 2048) likewise ([xlstm]:
     256 chained steps against the forward within 1e-4, a decode step at
     B = 4 with no host sync, decode and T = 2048 prefill ms beside bounds;
     [mixer-mesh]: the mesh forms (jamba's Mamba at (1, 4), xlstm-350m's
     mLSTM and sLSTM at (1, 2), every shard on cuda:0, float32) against the
     whole forms over a 64-token prefill and 8 decode steps, outputs and
     state within TOL, no weight fetched, a step's ms beside the whole
     form's
     counting bf16 products at the bf16 peak and float32 ones at
     float32's).
  4. main path: ServeEngine(scheduler="continuous"), the default, serving
     llama31-8b at full width (32 layers, seeded random bf16 weights) with
     FreeKV defaults, recall_overlap=True and the KV pool in pinned host
     memory, over 4 slots: 8 requests of needle prompts of 8192, 6144, 4096
     and 7168 tokens (two of each) with 40 and 16 greedy tokens in turn, so
     slots turn over while other lanes decode and a page completes during
     decode; five times: method freekv with kv_quant none and int8,
     shadowkv with none and int8, centroid with none. Before them the
     static lockstep path (freekv/none) serves the same 8 requests in two
     left-padded batches of 4, in the same process, for the comparison. Every kernel's launch count
     is zeroed just before each run and read just after; each kernel the
     run takes must rise (select_pages in every run, centroid_candidates
     under centroid), flash_prefill and fill_pages must launch once a layer
     for each prefill, complete_page once a layer for each decode step, and
     the scores-only and summary-only entries page_scores, centroid_scores
     and page_summary must not launch; on the continuous path every
     layer's pool must hold a page that only a completion in decode writes. Each run logs tokens and TTFT per request, decode ms a step,
     host reads a generated token, tokens/s and peak memory. After each
     continuous run an eager decode step is profiled
     (launch/decode_profile.py profile_decode): host ops and device
     operations a step and the device's busy share; for freekv/none also a
     continuous window of MAIN_WINDOW steps on the same state beside as many steps of the
     static engine (profile_window), and a step in which every row
     completes a page beside one in which none does (profile_completion).
     ShadowKV's low-rank key factorization is timed at one layer's shape.
     Then, in a fresh process (launch/gather_bench.py), the overlap line: 32
     paged_attention (one decode step's) alone and beside recall_gather on
     the staged-recall stream; and the four gathers again at the valid
     share of the continuous freekv/none run's top-up and staged recall
     launches (with --kernels-only: the overlap line only, after phase 3).
     At the end of phase 4 the [cost] line (``cost_phase``): one llama31-8b
     serve_step at the engine's shape (B 4, FreeKVConfig defaults, pinned
     pool, 8192-token prompts) counted by launch/op_cost on the card and on
     the meta device, FLOPs, bytes and every kernel's launches required
     equal, the launches equal to the card step's .launches deltas (32
     paged_attention, select_pages and complete_page, 64 recall_gather);
     then the cost model's analytic step bound (launch/roofline.py), all
     over HBM and with the pool over PCIe, beside the measured continuous
     freekv/none ms/step and their share. Phase 3's bounds come from the
     same module's per-kernel formulas.
 4b. the scheduler's features at full width (llama31-8b, bf16, freekv/none,
     pinned pool), each pair the same traffic off, then on: (a) chunked
     prefill, budget 1024: four 2048-token prompts in 4 slots, then an
     8192-token one admitted while three decode (max token gap a request,
     chunks, flash_prefill once a layer a chunk and fill_pages once a layer
     a prefill, token agreement); (b) the prefix cache: four prompts sharing
     6144 tokens over 2 slots (TTFT, prefix_hit_tokens 6144 for requests
     1-3, the pinned copies' ms); (c) preemption: four priority-0 requests
     in the 4 slots and a priority-1 fifth (the victim's tokens equal, swap
     bytes in == out, the swap timed, the urgent request's TTFT).
 4c. the other archs and retrievers at full width (seeded random bf16
     weights, pinned pool, 4 needle requests of 8192/6144/4096/7168 tokens,
     16 greedy tokens each, over 4 slots, continuous): qwen25-7b,
     gemma2-2b (its prompts past its 4096-token window), smollm-360m and
     stablelm-3b under freekv, deepseek-moe-16b (MoE, 16/16 heads; its
     ~33 GB of weights beside llama31-8b's, freed after the run) under
     freekv, then llama31-8b under quest, raas,
     streaming, infinigen and freekv with select_top_p 0.9; each run's
     kernels must launch (WIDE_RUNS), flash_prefill once a layer a prefill
     and complete_page once a global layer a step; each logs TTFT, decode
     ms/step, tokens/s, peak memory and its own launch counts (zeroed just
     before it), whose sums the kernels line gives as wide_launches, apart
     from phase 4's main-path launches. Then xlstm-350m (2048-token
     prompts; no kernel may launch), whisper-tiny (1500 seeded frames a
     request; flash_prefill once an encoder and a decoder layer an
     admission) and internvl2-26b (1024 seeded patches ahead of each
     prompt, ~40 GB of weights, built after deepseek's are freed; its
     decode profiled: host ops a step, busy share) at full width.
 4d. the sampler (card against CPU) and speculative decoding at full width
     (spec_phase; its launches are the kernels line's spec_launches).
 4e. live serving at full width: llama31-8b bf16, freekv/none, pinned pool,
     recall overlap, continuous over 4 slots, Observability.full() and SLOs
     of 2000 ms TTFT and 500 ms inter-token latency, the engine on the
     EngineService's worker thread and the HTTP front-end on 127.0.0.1.
     Nine streaming clients arrive on a seeded exponential schedule (mean
     gap 0.5 s): phase 4's eight requests, whose streamed tokens must equal
     phase 4's continuous freekv/none tokens, and, third, a 4096-token
     request for 64 tokens that closes its socket after its 4th token and
     must end CANCELLED (one cancellation, its tokens its direct run's);
     then the nine through generate() on the same engine, for the tokens
     and the decode ms/step without the front-end.
     /healthz, /metrics (Prometheus text) and /stats (the board's snapshot)
     are read and checked with requests in flight; every slot must be free
     at the end, no client may see an error event, the kernels launch as
     phase 4 requires (counted from just before the service starts: the
     kernels line's service_launches), the written trace and JSONL snapshot
     must validate. Logs client TTFT and token-gap percentiles, the SLO
     summary, decode ms/step beside phase 4's, host reads a token, peak GiB.
  4f. KV-head-group tensor parallelism at full width (tp_phase): llama31-8b,
     bf16, freekv, pinned pool, recall overlap, continuous over 4 slots,
     phase 4's eight requests through ServeEngine over a 2-shard mesh with
     both shards on cuda:0 (make_tp_mesh(2, ("cuda:0", "cuda:0"))): none at
     full depth, int8 at half depth, each held against phase 4's run of the
     same method, quantization and depth: tokens and steps equal, exposed,
     hidden and dropped bytes equal, each shard's measured bytes of each
     (summary()["tp"]["shard_transfer_bytes"], from its own counters) adding
     up to them and equal to the flight tracker's, paged_attention, select_pages, fill_pages, complete_page and the
     recall gather launched exactly twice phase 4's counts and flash_prefill
     as often (the backbone runs once), each shard's pool holding a page
     only a decode completion writes. Logs decode ms/step and TTFT beside
     phase 4's, peak GiB and (none) a profiled eager step's host ops and
     busy share beside phase 4's; with two cards or more the none case
     runs on cuda:0 and cuda:1 too. Its launches are the kernels line's
     tp_launches.
 4g. serving over a ("data", "model") compute mesh, every shard on cuda:0
     (mesh_phase): (a) llama31-8b at (2, 2), (b) the fused step at (1, 4),
     (c) smollm-360m at (1, 2), (h) smollm-360m at (1, 2) with draft_len 4
     and hints, its tokens (c)'s, (d) deepseek-moe-16b cut to 4 layers at
     (1, 4); (e) xlstm-350m at full depth at (1, 2) (256-token prompts),
     (f) whisper-tiny at (1, 2), (g) jamba-1.5-large-398b-smoke at (2, 2),
     each also at 1 x 1 (tokens and launches equal no mesh's) and request
     0 greedy in float32 (logits within 2e-4 of the largest |logit| of no
     mesh's, xlstm-350m cut to one mLSTM and one sLSTM layer; bf16 flips
     reported with their margins); then the 1 x 1 gate,
     the float32 gate and the fused step card against CPU. Its launches
     are the kernels line's mesh_launches.
  5. kernel path == plain path: granite-3-8b-smoke at float32 gives the same
     greedy tokens on the card (kernels) and on the CPU (plain versions):
     static, freekv and shadowkv under kv_quant none, int8 and int4,
     centroid under none and int8 with a re-center at every completed page;
     continuous, freekv under none and int8, shadowkv and centroid under
     none, 5 requests of mixed lengths over 2 slots, one of them ended by an
     eos inside a window; freekv with chunk budgets of a page, a token and
     10 tokens, a prefix-cache hit, and a preemption under none and int8;
     quest, raas, streaming, infinigen and freekv with select_top_p on
     granite-3-8b-smoke, and the seven other archs at smoke width and at
     their real head layouts (gemma2 also with a chunked prefill), through
     the continuous scheduler (NEW_PATHS); deepseek-moe-16b-smoke and
     jamba-1.5-large-398b-smoke over 6 slots and llama4-scout-17b-a16e-smoke
     over 8 (MOE_PATHS: more requests than slots, so lanes idle and turn
     over and decode capacity binds), deepseek and scout also with a chunked
     prefill (a held lane), jamba with a preemption; xlstm-350m,
     whisper-tiny and internvl2-26b at smoke width and the last two at
     their real head layouts, 5 requests over 2 slots with seeded frontends
     (one without), through the continuous scheduler, the static path and a
     preemption, each engine's chunk budget and prefix cache reading off
     (XARCH_PATHS); tensor parallelism over two shards on cuda:0 against two
     on the CPU and against tp=1 on the CPU (tp_paths_vs_plain: continuous
     freekv none and int8, a preemption, a prefix-cache hit, the static
     path); and the centroid index kept step by step on the card
     equals its rebuild bit for bit.
  6. training: (a) smollm-360m at full width (32 layers, d 960, 15/5 heads,
     vocab 49152, ~362 M params), float32 (TF32 off, reported), B=4,
     T=4096 (the chunked attention, each KV chunk checkpointed, each layer
     rematerialised), 4 AdamW steps with the launcher's defaults (lr 1e-3,
     warmup steps // 10) on lm_batches(seed=0): each step's loss and grad
     norm (finite), s/step after the first, tokens/s, the step's FLOPs
     against the float32 bound, peak GiB (and what earlier phases left
     allocated), beside the card's name and power limit; no serving kernel
     may launch in a train step; one forward + backward profiled (device
     ms, busy share, the top kernels). (b) the state
     (params, m, v, step) saved to a checkpoint in the reference's layout
     and restored, every leaf bit-equal, the seconds logged; the trained
     weights cast to bf16 and served through ServeEngine (wide_run:
     freekv/none, 4 needle requests x 16 tokens over 4 slots, continuous),
     whose launches the kernels line gives as train_launches. (c)
     model-parallel training (train_mp_phase), every shard on cuda:0 by
     name, float32, TF32 off: smollm-360m at full width and depth on a
     (1, 2) ("data", "model") mesh (15/5 heads do not divide 2: the
     input-dim split, query-row attention, the vocab-parallel
     cross-entropy over 49152 / 2), B=4, T=4096, 2 steps with phase (a)'s
     AdamW and data, losses and grad norms within 1e-4 of phase (a)'s first
     two; deepseek-moe-16b at full width (d 2048, 64 experts of 1408,
     16/16 heads, vocab 102400), its depth cut to the dense prelude layer
     and 3 MoE periods (the only cut: 28 layers' float32 params and AdamW
     moments exceed the card), B=2, T=2048, 2 steps at (1, 1) and at (1, 4)
     (16 experts a shard), losses and grad norms within 1e-4; each run's
     s/step, tokens/s, peak GiB in a freed allocator, and the step's bytes
     moved between shards by kind with their time over NVLink (computed,
     not measured); no serving kernel may launch. (d) each of the eight
     smoke archs trained 3 steps (B=2, T=128) on the card and on the CPU
     from the same params and batches, losses within 1e-4 relative, then
     the card's trained weights served greedy on both, card tokens == CPU
     tokens; and deepseek-moe-16b-smoke, llama4-scout-17b-a16e-smoke,
     smollm-360m-smoke and gemma2-2b-smoke trained 3 steps on (2, 2) and
     (1, 4) meshes, four shards on cuda:0 against four on the CPU, losses
     within 1e-4 (the (2, 2) runs route the MoE per data block). Phase 6c
     also trains xlstm-350m (one mLSTM and one sLSTM layer, B=2, T=256) and
     whisper-tiny (B=2, T=448, seeded frames) at full width, 2 steps at
     (1, 1) and (1, 2), losses within 2e-5 (xlstm's first step: AdamW's
     first update turns gradients that round to either side of 0 into
     steps of lr apart) and the first batch's gradients within 1e-4
     relative L2 leaf by leaf.
Then one JSON line with the kernels' numbers and, last, the ok line.
"""
import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.kernels import cost as kcost  # noqa: E402  (pure Python, no torch op)
from repro_torch.launch import roofline as rl  # noqa: E402

# the card's rates (H100 SXM data sheet: HBM, the dense bf16 tensor-core
# peak for the bf16 timings, float32 outside the tensor cores with TF32 off,
# PCIe Gen5 x16 a direction) and the bounds come from the cost model,
# launch/roofline.py (``rl``); each kernel's bytes and operations from
# kernels/cost.py (``kcost``)
L2_BYTES = 50 * 2 ** 20
# a kernel against its plain version on the same inputs, by OUTPUT dtype. The
# two compute in float32 and differ only in summation order; a bfloat16
# output is that result rounded once, so the two may land one bf16 step
# apart: rtol 2**-6 is two steps of bf16's 8-bit significand, and atol 1e-4
# is under 0.3% of paged_attention's typical output (~0.036 at L=2080).
# tests/test_kernels.py's 5e-2 is for bfloat16 against JAX's oracle, a
# different computation, and is not used here.
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=1e-4, rtol=2 ** -6)}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(msg):
    print(msg, flush=True)


START = time.perf_counter()


def mark(phase):
    """The script's seconds so far, logged as ``phase`` ends."""
    log(f"[time] {phase} done at {time.perf_counter() - START:.1f} s")


def time_ms(fn, args_list, iters=50):
    """(device ms, call ms) per call over ``iters`` calls cycling through
    ``args_list`` (copies of the inputs, sized so the cycle exceeds L2).

    Device ms sums the card-side rows (kernels, copies) of a torch.profiler
    trace of the calls: the time the card spends (launch/gather_bench.py
    device_ms, which runs a session again when the profiler drops its
    device events, and after three such sessions times the calls with CUDA
    events queued behind a spin, noted on stderr and counted in the
    ``[timing]`` line). Call ms is
    CUDA-event time per call, which also holds the gaps while the host
    launches the next call; for a kernel of a few microseconds that gap is
    most of it."""
    from repro_torch.launch.gather_bench import device_ms
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    stop.record()
    torch.cuda.synchronize()
    return device_ms(fn, args_list, iters), start.elapsed_time(stop) / iters


def copies_for(nbytes):
    return max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def link_info(dev):
    """The card's PCIe link as nvidia-smi and sysfs report it, and its NUMA
    node; "not readable" where neither says (a machine may hide both)."""
    q = subprocess.run(["nvidia-smi", "--query-gpu=pcie.link.gen.current,pcie.link.width.current",
                        "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    gen_width = [x.strip() for x in q.stdout.strip().split(",")] if q.returncode == 0 else []
    pr = torch.cuda.get_device_properties(dev)
    bus = f"{pr.pci_domain_id:04x}:{pr.pci_bus_id:02x}:{pr.pci_device_id:02x}.0"
    sysfs = Path("/sys/bus/pci/devices") / bus

    def read(name):
        try:
            return (sysfs / name).read_text().strip()
        except OSError:
            return "not readable"
    return {"pci_bus": bus,
            "nvidia_smi_gen": gen_width[0] if gen_width else "not readable",
            "nvidia_smi_width": gen_width[1] if len(gen_width) > 1 else "not readable",
            "sysfs_speed": read("current_link_speed"), "sysfs_width": read("current_link_width"),
            "numa_node": read("numa_node")}


def run_gather_bench(share):
    """launch/gather_bench.py in a fresh process: the overlap line with
    every lane valid, and the four gathers likewise; when phase 4 measured
    the main path's valid shares, the gathers at both and the overlap line
    at the staged recall's too -> its JSON line."""
    root = Path(__file__).resolve().parent
    shares = ["1.0"] + ([repr(v) for v in share.values()] if share else [])
    overlap_shares = ["1.0"] + ([repr(share["staged"])] if share else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.gather_bench", "--shares",
                          *shares, "--overlap-shares", *overlap_shares], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    require(out.returncode == 0, f"gather_bench exited {out.returncode}:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def host_gather_grid(ops, source, dev, halves):
    """The grids a gather of csrc/<source>.cu launches at the main shape,
    from a pinned host pool (and the SMs' worth that is, by the runtime's
    occupancy) and from a device pool; ``halves`` units an item (2 for K and
    V, 1 for V only)."""
    bps = ops.gather_blocks_per_sm(source, dev.index)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = ops.gather_grid(halves * B * KV * N_SEL, sms, bps, True)
    return {"host_grid_blocks": grid, "blocks_per_sm": bps, "host_sms": grid / bps,
            "device_grid_blocks": ops.gather_grid(halves * B * KV * N_SEL, sms, bps, False)}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the main path's shapes
# ---------------------------------------------------------------------------
B, KV, G, D, P, N_SEL = 4, 8, 4, 128, 32, 56
N_SINK, N_WIN = 128, 128 + 32
L = N_SINK + N_WIN + N_SEL * P            # 2080
CONTEXT, NEW_TOKENS = 8192, 40            # 40: the 32nd decode step completes a page
# the continuous runs' traffic: 8 requests over B slots (multiples of 32)
CONT_PROMPTS = (8192, 6144, 4096, 7168) * 2
CONT_NEW = (40, 16) * 4
MAX_LEN = CONTEXT + 2 * NEW_TOKENS
N_PAGES = -(-MAX_LEN // P)                # 259
H = KV * G                                # 32 query heads
N_CENT = 16                               # FreeKVConfig.centroid_count


def _sdpa_paged_inputs(q, k, v, pos, cur):
    """Paged attention's inputs as SDPA takes them: K/V heads expanded to the
    G query heads and a boolean mask over the same keys."""
    b, kv, g, d = q.shape
    n = k.shape[2] * k.shape[3]
    kk = k.reshape(b, kv, n, d).repeat_interleave(g, dim=1)
    vv = v.reshape(b, kv, n, d).repeat_interleave(g, dim=1)
    mask = ((pos >= 0) & (pos <= cur[:, None, None, None])).reshape(b, kv, 1, n)
    return q.reshape(b, kv * g, 1, d), kk, vv, mask.repeat_interleave(g, dim=1)


def _sdpa(q, k, v, mask, scale):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


def _library_precision(got, want, dt):
    """The yardstick's own max |error| against the plain version, and
    whether it lies within the TOL the kernel is held to."""
    return {"library_max_abs_err": (got.float() - want.float()).abs().max().item(),
            "library_within_tol": bool(torch.allclose(got.float(), want.float(), **TOL[dt]))}


def check_paged_attention(ops, ref, dev, gen):
    out = {}
    lib_prec = None
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(B, KV, G, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, KV, L // P, P, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, KV, L // P, P, D, generator=gen, device=dev).to(dt)
        pos = torch.randint(-1, CONTEXT + 8, (B, KV, L // P, P), generator=gen,
                            device=dev, dtype=torch.int32)
        pos[:, :, 5] = -1                             # a fully masked page
        cur = torch.full((B,), CONTEXT, dtype=torch.int32, device=dev)  # some pos > cur
        scale = 1.0 / math.sqrt(D)
        got = ops.paged_attention(q, k, v, pos, cur, scale=scale)
        want = ref.paged_attention_ref(q, k, v, pos, cur, scale)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        require(torch.allclose(got.float(), want.float(), **TOL[dt]),
                f"paged_attention {dt}: max |err| {err} (max |want| "
                f"{want.float().abs().max().item()}), tolerance {TOL[dt]}")
        out[dt] = err
        if dt == torch.bfloat16:
            lib = _sdpa(*_sdpa_paged_inputs(q, k, v, pos, cur), scale).reshape(B, KV, G, D)
            lib_prec = _library_precision(lib, want, dt)
    # timing at bf16, the main path's dtype
    dt = torch.bfloat16
    n = copies_for(2 * B * KV * L * D * 2)
    args = []
    for _ in range(n):
        q = torch.randn(B, KV, G, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, KV, L // P, P, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, KV, L // P, P, D, generator=gen, device=dev).to(dt)
        pos = torch.arange(L, dtype=torch.int32, device=dev).reshape(1, 1, L // P, P)
        pos = pos.expand(B, KV, -1, -1).contiguous()
        cur = torch.full((B,), L - 1, dtype=torch.int32, device=dev)
        args.append((q, k, v, pos, cur))
    scale = 1.0 / math.sqrt(D)
    ms, call_ms = time_ms(lambda *a: ops.paged_attention(*a, scale=scale), args)
    plain_ms, _ = time_ms(lambda *a: ref.paged_attention_ref(*a, scale), args, iters=10)
    # yardstick: SDPA with a boolean mask over the same keys, timed on inputs
    # already expanded to the G query heads
    sdpa_args = [_sdpa_paged_inputs(*a) for a in args]
    lib_ms, _ = time_ms(lambda q, k, v, m: _sdpa(q, k, v, m, scale), sdpa_args)
    return {"name": "paged_attention", "shape": f"q({B},{KV},{G},{D}) kv({B},{KV},{L // P},{P},{D})",
            **rl.kernel_bound(kcost.paged_attention(B, KV, G, L // P, P, D, 2)),
            "max_abs_err": out[torch.bfloat16], "max_abs_err_fp32": out[torch.float32],
            "tol": TOL[torch.bfloat16], "tol_fp32": TOL[torch.float32],
            "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_call": "scaled_dot_product_attention(bool mask)",
            **lib_prec}


def check_page_scores(ops, ref, dev, gen):
    out = {}

    def inputs(dt):
        q = torch.randn(B, KV, G, D, generator=gen, device=dev).to(dt)
        summ = torch.sort(torch.randn(B, N_PAGES, KV, 2, D, generator=gen, device=dev),
                          dim=3).values.to(dt)
        return q, summ

    scale = 1.0 / math.sqrt(D)
    tol = TOL[torch.float32]          # the output is float32 for either input dtype
    for dt in (torch.float32, torch.bfloat16):
        q, summ = inputs(dt)
        got = ops.page_scores(q, summ, scale=scale)
        want = ref.page_scores_ref(q, summ, scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        require(torch.allclose(got, want, **tol),
                f"page_scores {dt}: max |err| {err}, tolerance {tol}")
        out[dt] = err
    dt = torch.bfloat16
    args = [inputs(dt) for _ in range(copies_for(B * N_PAGES * KV * 2 * D * 2))]
    ms, call_ms = time_ms(lambda q, s: ops.page_scores(q, s, scale=scale), args)
    plain_ms, _ = time_ms(lambda q, s: ref.page_scores_ref(q, s, scale), args, iters=10)
    # yardstick: relu(q) @ hi^T + min(q, 0) @ lo^T, two matmuls
    mm_args = [(torch.relu(q), torch.clamp(q, max=0),
                s[..., 1, :].permute(0, 2, 3, 1), s[..., 0, :].permute(0, 2, 3, 1))
               for q, s in args]
    lib_ms, _ = time_ms(lambda qp, qn, hi, lo: (torch.matmul(qp, hi) + torch.matmul(qn, lo)) * scale,
                        mm_args)
    return {"name": "page_scores", "shape": f"q({B},{KV},{G},{D}) summ({B},{N_PAGES},{KV},2,{D})",
            **rl.kernel_bound(kcost.page_scores(B, KV, G, N_PAGES, D, 2)),
            "max_abs_err": out[torch.bfloat16], "max_abs_err_fp32": out[torch.float32],
            "tol": tol, "tol_fp32": tol,
            "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_call": "2x torch.matmul"}


def check_recall_gather(ops, ref, dev, gen):
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        pool = torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen, device=dev).to(dt)
        idx = torch.randint(-1, N_PAGES, (B, KV, N_SEL), generator=gen, device=dev,
                            dtype=torch.int32)
        want = ref.recall_gather_ref(pool, idx)
        for src in (pool, pool.cpu().pin_memory()):
            got = ops.recall_gather(src, idx)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                err = (a.float() - b.float()).abs().max().item()
                require(torch.equal(a, b), f"recall_gather {dt} from {src.device}: "
                        f"not bit-exact (max |err| {err})")
                errs.append(err)
    # timing at bf16, every lane valid (the bound's worst case), from the
    # pinned pool cycling selections with disjoint pages (no call reads a
    # page an earlier one left in L2), beside the link's ceiling
    from repro_torch.launch import gather_bench
    dt = torch.bfloat16
    pool = torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen, device=dev).to(dt)
    host = pool.cpu().pin_memory()
    sels = gather_bench.selections(gen, dev)
    idx = sels[0]
    ms_host, call_ms = time_ms(ops.recall_gather, [(host, i) for i in sels])
    ms_dev, _ = time_ms(ops.recall_gather, [(pool, idx)])
    plain_ms, _ = time_ms(ref.recall_gather_ref, [(pool, idx)])
    bI = torch.arange(B, device=dev)[:, None, None]
    kI = torch.arange(KV, device=dev)[None, :, None]
    lib_ms, _ = time_ms(lambda p_, i_: p_[bI, i_.long(), kI], [(pool, idx)])
    valid = int((idx >= 0).sum())
    host = kcost.recall_gather(B, KV, N_SEL, P, D, 2, valid=valid)
    moved = host["link_bytes"]
    return {"name": "recall_gather", "shape": f"pool({B},{N_PAGES},{KV},2,{P},{D}) idx({B},{KV},{N_SEL})",
            **rl.kernel_bound(host), "bound_link": "PCIe for the pinned host pool",
            "link_ms": gather_bench.link_ms(moved, dev), "moved_bytes": moved,
            **host_gather_grid(ops, "recall_gather", dev, 2),
            "max_abs_err": max(errs), "tol": 0.0,
            "kernel_ms": ms_host, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "device_pool_ms": ms_dev, "device_pool_bound_ms": rl.kernel_bound(kcost.recall_gather(
                B, KV, N_SEL, P, D, 2, valid=valid, host=False))["bound_ms"],
            "library_ms": lib_ms, "library_call": "advanced indexing on a device pool"}


def check_recall_gather_quant(ops, ref, dev, gen):
    from repro_torch.quant.quantizers import quantize_block
    errs = []
    for bits, group in ((8, 0), (4, 0), (8, 32), (4, 16)):
        pool_f = torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen, device=dev)
        pool_f[:, 3] = 0                              # zero pages: scale 1
        pool, scales = quantize_block(pool_f, bits, group)
        idx = torch.randint(-2, N_PAGES, (B, KV, N_SEL), generator=gen, device=dev,
                            dtype=torch.int32)        # -1 and -2 lanes
        for dt in (torch.float32, torch.bfloat16):
            want = ref.recall_gather_quant_ref(pool, scales, idx, bits, dt)
            for src, ssrc in ((pool, scales), (pool.cpu().pin_memory(), scales.cpu().pin_memory())):
                got = ops.recall_gather_quant(src, ssrc, idx, bits=bits, out_dtype=dt)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    err = (a.float() - b.float()).abs().max().item()
                    require(a.dtype == dt and torch.equal(a, b),
                            f"recall_gather_quant int{bits} g{group} {dt} from {src.device}: "
                            f"not bit-exact (max |err| {err})")
                    errs.append(err)
    # timing at the main path's settings (group 0, bf16 out), every lane
    # valid, from the pinned host pool cycling selections with disjoint pages
    from repro_torch.launch import gather_bench
    sels = gather_bench.selections(gen, dev)
    idx = sels[0]
    dt = torch.bfloat16
    row = {}
    for bits in (8, 4):
        pool, scales = quantize_block(torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen,
                                                  device=dev), bits, 0)
        hp, hs = pool.cpu().pin_memory(), scales.cpu().pin_memory()
        fn = lambda p_, s_, i_: ops.recall_gather_quant(p_, s_, i_, bits=bits, out_dtype=dt)
        ms_host, call_ms = time_ms(fn, [(hp, hs, i) for i in sels])
        ms_dev, _ = time_ms(fn, [(pool, scales, idx)])
        plain_ms, _ = time_ms(lambda p_, s_, i_: ref.recall_gather_quant_ref(p_, s_, i_, bits, dt),
                              [(pool, scales, idx)], iters=10)
        valid = int((idx >= 0).sum())
        cost = {host: kcost.recall_gather_quant(B, KV, N_SEL, P, D, bits, scales.shape[-1], 2,
                                             valid=valid, host=host) for host in (True, False)}
        moved = cost[True]["link_bytes"]
        row[bits] = {"ms": ms_host, "call_ms": call_ms, "device_pool_ms": ms_dev,
                     "plain_ms": plain_ms, "moved_bytes": moved,
                     "bound_ms": rl.kernel_bound(cost[True])["bound_ms"],
                     "device_pool_bound_ms": rl.kernel_bound(cost[False])["bound_ms"],
                     "link_ms": gather_bench.link_ms(moved, dev)}
    r8 = row[8]
    return {"name": "recall_gather_quant", "link_ms": r8["link_ms"],
            "moved_bytes": r8["moved_bytes"],
            **host_gather_grid(ops, "recall_gather_quant", dev, 2),
            "shape": f"pool({B},{N_PAGES},{KV},2,{P},{D}*bits/8) int8, scales({B},{N_PAGES},{KV},2,1) "
                     f"idx({B},{KV},{N_SEL}) -> bf16",
            "bound_bytes": r8["moved_bytes"], "bound_ops": 0, "bound_ms": r8["bound_ms"],
            "bound_by": "bytes", "bound_link": "PCIe for the pinned host pool",
            "max_abs_err": max(errs), "tol": 0.0,
            "kernel_ms": r8["ms"], "kernel_call_ms": r8["call_ms"], "plain_ms": r8["plain_ms"],
            "device_pool_ms": r8["device_pool_ms"],
            "device_pool_bound_ms": r8["device_pool_bound_ms"],
            "int4": row[4], "library_ms": None,
            "library_call": "none: no single PyTorch call gathers and dequantizes"}


def _distinct_idx(gen, dev):
    """Every lane valid, distinct pages per (b, kv head): the bound's worst case."""
    return torch.stack([torch.randperm(N_PAGES, generator=gen, device=dev)[:N_SEL]
                        for _ in range(B * KV)]).reshape(B, KV, N_SEL).to(torch.int32)


def check_recall_values(ops, ref, dev, gen):
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        pool = torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen, device=dev).to(dt)
        idx = torch.randint(-1, N_PAGES, (B, KV, N_SEL), generator=gen, device=dev,
                            dtype=torch.int32)
        want = ref.recall_values_ref(pool, idx)
        for src in (pool, pool.cpu().pin_memory()):
            got = ops.recall_values(src, idx)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            require(got.dtype == dt and torch.equal(got, want),
                    f"recall_values {dt} from {src.device}: not bit-exact (max |err| {err})")
            errs.append(err)
    from repro_torch.launch import gather_bench
    dt = torch.bfloat16
    pool = torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen, device=dev).to(dt)
    host = pool.cpu().pin_memory()
    sels = gather_bench.selections(gen, dev)          # disjoint pages, every lane valid
    idx = sels[0]
    valid = int((idx >= 0).sum())
    cost = {host: kcost.recall_values(B, KV, N_SEL, P, D, 2, valid=valid, host=host)
            for host in (True, False)}
    moved = cost[True]["link_bytes"]
    ms_host, call_ms = time_ms(ops.recall_values, [(host, i) for i in sels])
    # from the device pool, selections cycled so the pages read are not L2-resident
    dev_args = [(pool, _distinct_idx(gen, dev))
                for _ in range(copies_for(rl.kernel_bound(cost[False])["bound_bytes"]))]
    ms_dev, _ = time_ms(ops.recall_values, dev_args)
    plain_ms, _ = time_ms(ref.recall_values_ref, dev_args)
    bI = torch.arange(B, device=dev)[:, None, None]
    kI = torch.arange(KV, device=dev)[None, :, None]
    lib_ms, _ = time_ms(lambda p_, i_: p_[bI, i_.long(), kI, 1], dev_args)
    return {"name": "recall_values",
            "shape": f"pool({B},{N_PAGES},{KV},2,{P},{D}) idx({B},{KV},{N_SEL}) -> V only",
            **rl.kernel_bound(cost[True]), "bound_link": "PCIe for the pinned host pool",
            "link_ms": gather_bench.link_ms(moved, dev), "moved_bytes": moved,
            **host_gather_grid(ops, "recall_gather", dev, 1),
            "max_abs_err": max(errs), "tol": 0.0,
            "kernel_ms": ms_host, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "device_pool_ms": ms_dev,
            "device_pool_bound_ms": rl.kernel_bound(cost[False])["bound_ms"],
            "library_ms": lib_ms, "library_call": "advanced indexing of pool[..., 1, :, :] "
                                                  "on a device pool"}


def check_recall_values_quant(ops, ref, dev, gen):
    from repro_torch.quant.quantizers import quantize_block
    errs = []
    for bits, group in ((8, 0), (4, 0), (8, 16), (4, 16), (8, 32), (4, 32)):
        pool_f = torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen, device=dev)
        pool_f[:, 3] = 0                              # zero pages: scale 1
        pool, scales = quantize_block(pool_f, bits, group)
        idx = torch.randint(-2, N_PAGES, (B, KV, N_SEL), generator=gen, device=dev,
                            dtype=torch.int32)        # -1 and -2 lanes
        for dt in (torch.float32, torch.bfloat16):
            want = ref.recall_values_quant_ref(pool, scales, idx, bits, dt)
            for src, ssrc in ((pool, scales), (pool.cpu().pin_memory(), scales.cpu().pin_memory())):
                got = ops.recall_values_quant(src, ssrc, idx, bits=bits, out_dtype=dt)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                require(got.dtype == dt and torch.equal(got, want),
                        f"recall_values_quant int{bits} g{group} {dt} from {src.device}: "
                        f"not bit-exact (max |err| {err})")
                errs.append(err)
    from repro_torch.launch import gather_bench
    sels = gather_bench.selections(gen, dev)          # disjoint pages, every lane valid
    idx = sels[0]
    dt = torch.bfloat16
    row = {}
    for bits in (8, 4):
        pool, scales = quantize_block(torch.randn(B, N_PAGES, KV, 2, P, D, generator=gen,
                                                  device=dev), bits, 0)
        hp, hs = pool.cpu().pin_memory(), scales.cpu().pin_memory()
        valid = int((idx >= 0).sum())
        cost = {host: kcost.recall_values_quant(B, KV, N_SEL, P, D, bits, scales.shape[-1], 2,
                                             valid=valid, host=host) for host in (True, False)}
        moved = cost[True]["link_bytes"]
        fn = lambda p_, s_, i_: ops.recall_values_quant(p_, s_, i_, bits=bits, out_dtype=dt)
        ms_host, call_ms = time_ms(fn, [(hp, hs, i) for i in sels])
        dev_args = [(pool, scales, _distinct_idx(gen, dev))
                    for _ in range(copies_for(rl.kernel_bound(cost[False])["bound_bytes"]))]
        ms_dev, _ = time_ms(fn, dev_args)
        plain_ms, _ = time_ms(lambda p_, s_, i_: ref.recall_values_quant_ref(p_, s_, i_, bits, dt),
                              dev_args, iters=10)
        row[bits] = {"ms": ms_host, "call_ms": call_ms, "device_pool_ms": ms_dev,
                     "plain_ms": plain_ms, "moved_bytes": moved,
                     "bound_ms": rl.kernel_bound(cost[True])["bound_ms"],
                     "device_pool_bound_ms": rl.kernel_bound(cost[False])["bound_ms"],
                     "link_ms": gather_bench.link_ms(moved, dev)}
    r8 = row[8]
    return {"name": "recall_values_quant", "link_ms": r8["link_ms"],
            "moved_bytes": r8["moved_bytes"],
            **host_gather_grid(ops, "recall_gather_quant", dev, 1),
            "shape": f"pool({B},{N_PAGES},{KV},2,{P},{D}*bits/8) int8, "
                     f"scales({B},{N_PAGES},{KV},2,1) idx({B},{KV},{N_SEL}) -> V only, bf16",
            "bound_bytes": r8["moved_bytes"], "bound_ops": 0, "bound_ms": r8["bound_ms"],
            "bound_by": "bytes", "bound_link": "PCIe for the pinned host pool",
            "max_abs_err": max(errs), "tol": 0.0,
            "kernel_ms": r8["ms"], "kernel_call_ms": r8["call_ms"], "plain_ms": r8["plain_ms"],
            "device_pool_ms": r8["device_pool_ms"],
            "device_pool_bound_ms": r8["device_pool_bound_ms"],
            "int4": row[4], "library_ms": None,
            "library_call": "none: no single PyTorch call gathers and dequantizes"}


def check_centroid_scores(ops, ref, dev, gen):
    out = {}

    def inputs(dt):
        q = torch.randn(B, KV, G, D, generator=gen, device=dev).to(dt)
        cent = torch.sort(torch.randn(B, N_CENT, KV, 2, D, generator=gen, device=dev),
                          dim=3).values.to(dt)
        count = torch.randint(0, 4, (B, N_CENT, KV), generator=gen, device=dev,
                              dtype=torch.int32)          # some empty clusters
        return q, cent, count

    scale = 1.0 / math.sqrt(D)
    tol = TOL[torch.float32]          # the output is float32 for either input dtype
    for dt in (torch.float32, torch.bfloat16):
        q, cent, count = inputs(dt)
        got = ops.centroid_scores(q, cent, count, scale=scale)
        want = ref.centroid_scores_ref(q, cent, count, scale)
        torch.cuda.synchronize()
        empty = (count == 0).permute(0, 2, 1)[:, :, None, :].expand_as(got)
        require(bool(empty.any()) and bool((got[empty] == -1e30).all()),
                f"centroid_scores {dt}: an empty cluster does not score exactly -1e30")
        err = (got - want).abs().max().item()
        require(torch.allclose(got, want, **tol),
                f"centroid_scores {dt}: max |err| {err}, tolerance {tol}")
        out[dt] = err
    dt = torch.bfloat16
    args = [inputs(dt) for _ in range(copies_for(B * N_CENT * KV * 2 * D * 2))]
    ms, call_ms = time_ms(lambda q, c, n: ops.centroid_scores(q, c, n, scale=scale), args)
    plain_ms, _ = time_ms(lambda q, c, n: ref.centroid_scores_ref(q, c, n, scale), args, iters=10)
    # yardstick: relu(q) @ hi^T + min(q, 0) @ lo^T, two matmuls, and the mask
    mm_args = [(torch.relu(q), torch.clamp(q, max=0), c[..., 1, :].permute(0, 2, 3, 1),
                c[..., 0, :].permute(0, 2, 3, 1), (n > 0).permute(0, 2, 1)[:, :, None, :])
               for q, c, n in args]
    lib_ms, _ = time_ms(lambda qp, qn, hi, lo, ok: torch.where(
        ok, (torch.matmul(qp, hi) + torch.matmul(qn, lo)) * scale, -1e30), mm_args)
    return {"name": "centroid_scores",
            "shape": f"q({B},{KV},{G},{D}) cent({B},{N_CENT},{KV},2,{D}) count({B},{N_CENT},{KV})",
            **rl.kernel_bound(kcost.centroid_scores(B, KV, G, N_CENT, D, 2)),
            "max_abs_err": out[torch.bfloat16], "max_abs_err_fp32": out[torch.float32],
            "tol": tol, "tol_fp32": tol,
            "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_call": "2x torch.matmul + torch.where"}


SELECT_MODES = ("mean_softmax", "max_softmax", "mean_qk", "max_qk")
N_LARGE = 32768                           # the pages of a 1M-token context: blocks' workspace


def _select_plain_composition(ops, ref, scale, n_sel, mode):
    """What select_pages replaces on the card: the page_scores kernel, then
    the plain mask, group pooling, stable sort and -1 padding."""
    def run(q, summ, length):
        s = ops.page_scores(q, summ, scale=scale)
        ok = ref.selectable_mask_ref(summ.shape[1], length, P, N_SINK, N_WIN)
        pooled = ref.group_pool_ref(s, ok[:, None, :].expand(-1, q.shape[1], -1), mode)
        return ref.top_ids(pooled, None, n_sel)
    return run


def check_select_pages(ops, ref, dev, gen):
    """select_pages against its plain version: exact ids on far-apart,
    forced-tie and underflow inputs (every pooling mode, fp32 and bf16, the
    main shape, and bf16 MeanS at N_LARGE pages), tie-aware on random
    inputs, exact with -1 candidates; pooled within 2e-5."""
    from repro_torch.launch.select_bench import select_inputs, tie_aware_mismatch
    scale = 1.0 / math.sqrt(D)
    tol = TOL[torch.float32]
    err = 0.0

    def both(q, summ, length, mode, cand=None, n_sel=N_SEL):
        got = ops.select_pages(q, summ, length, n_sel=n_sel, scale=scale, page_size=P,
                               n_sink=N_SINK, n_window=N_WIN, mode=mode, cand=cand,
                               with_pooled=True)
        want = ref.select_pages_ref(q, summ, length, n_sel, scale, P, N_SINK, N_WIN, mode, cand)
        torch.cuda.synchronize()
        return got, want

    cases = [(b, N_PAGES, dt, mode) for dt in (torch.float32, torch.bfloat16)
             for mode in SELECT_MODES for b in (B,)] + [(1, N_LARGE, torch.bfloat16,
                                                         "mean_softmax")]
    for b, n, dt, mode in cases:
        for kind in ("distinct", "tie", "underflow", "random"):
            q, summ, length = select_inputs(kind, b, KV, G, D, n, N_SEL, dt, gen, dev)
            (idx, pooled), (want_idx, want_pooled) = both(q, summ, length, mode)
            what = f"select_pages {kind} {mode} {dt} N={n}"
            e = (pooled - want_pooled).abs().max().item()
            require(torch.allclose(pooled, want_pooled, **tol),
                    f"{what}: pooled max |err| {e}, tolerance {tol}")
            err = max(err, e)
            if kind == "random":
                bad = tie_aware_mismatch(idx, want_idx, want_pooled)
                require(bad is None, f"{what}: {bad}")
            else:
                require(torch.equal(idx, want_idx), f"{what}: page ids differ")
    for mode in SELECT_MODES:                     # stage 2 of centroid selection
        q, summ, length = select_inputs("distinct", B, KV, G, D, N_PAGES, N_SEL, torch.bfloat16,
                                        gen, dev)
        cand = torch.stack([torch.randperm(N_PAGES, generator=gen, device=dev)[:4 * N_SEL]
                            for _ in range(B * KV)]).reshape(B, KV, -1).to(torch.int32)
        cand[:, :, -30:] = -1
        (idx, _), (want_idx, _) = both(q, summ, length, mode, cand)
        require(torch.equal(idx, want_idx), f"select_pages with candidates {mode}: ids differ")
    # timing at bf16 MeanS, the main path's call
    dt, mode = torch.bfloat16, "mean_softmax"
    args = [select_inputs("random", B, KV, G, D, N_PAGES, N_SEL, dt, gen, dev)
            for _ in range(copies_for(B * N_PAGES * KV * 2 * D * 2))]
    ms, call_ms = time_ms(lambda q, s, n: ops.select_pages(
        q, s, n, n_sel=N_SEL, scale=scale, page_size=P, n_sink=N_SINK, n_window=N_WIN,
        mode=mode), args)
    comp = _select_plain_composition(ops, ref, scale, N_SEL, mode)
    comp_ms, comp_call_ms = time_ms(comp, args)
    plain_ms, _ = time_ms(lambda q, s, n: ref.select_pages_ref(q, s, n, N_SEL, scale, P, N_SINK,
                                                               N_WIN, mode), args, iters=10)
    return {"name": "select_pages",
            "shape": f"q({B},{KV},{G},{D}) summ({B},{N_PAGES},{KV},2,{D}) n_sel {N_SEL} MeanS",
            **rl.kernel_bound(kcost.select_pages(B, KV, G, N_PAGES, D, N_SEL, 2)),
            "max_abs_err": err, "tol": tol, "ids": "exact (tie-aware on random inputs)",
            "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "composition_ms": comp_ms, "composition_call_ms": comp_call_ms,
            "composition": "page_scores kernel + mask, pooling, stable sort (torch)",
            "library_ms": None, "library_call": "none: no single PyTorch call selects pages"}


def check_centroid_candidates(ops, ref, dev, gen):
    """centroid_candidates against its plain version: candidate ids exactly
    equal (empty clusters, unassigned pages, fewer selectable pages than m)
    in fp32 and bf16, at the main shape and at N_LARGE pages."""
    scale = 1.0 / math.sqrt(D)
    m = 4 * N_SEL

    def inputs(dt, n):
        q = torch.randn(B, KV, G, D, generator=gen, device=dev).to(dt)
        cent = torch.sort(torch.randn(B, N_CENT, KV, 2, D, generator=gen, device=dev),
                          dim=3).values.to(dt)
        assign = torch.randint(-1, N_CENT, (B, n, KV), generator=gen, device=dev,
                               dtype=torch.int32)
        count = torch.randint(1, 5, (B, N_CENT, KV), generator=gen, device=dev, dtype=torch.int32)
        count[:, 3] = 0                                   # an empty cluster
        length = torch.full((B,), (n - 2) * P + 7, dtype=torch.int32, device=dev)
        length[1] = N_SINK + N_WIN + 40 * P               # fewer selectable pages than m
        return q, cent, count, assign, length

    for dt in (torch.float32, torch.bfloat16):
        for n in (N_PAGES, N_LARGE):
            args = inputs(dt, n)
            got = ops.centroid_candidates(*args, m=m, scale=scale, page_size=P, n_sink=N_SINK,
                                          n_window=N_WIN)
            want = ref.centroid_candidates_ref(*args, m, scale, P, N_SINK, N_WIN)
            torch.cuda.synchronize()
            require(torch.equal(got, want) and bool((got[1] == -1).any()),
                    f"centroid_candidates {dt} N={n}: candidate ids differ")
    dt = torch.bfloat16
    args = [inputs(dt, N_PAGES) for _ in range(4)]
    ms, call_ms = time_ms(lambda *a: ops.centroid_candidates(
        *a, m=m, scale=scale, page_size=P, n_sink=N_SINK, n_window=N_WIN), args)

    def comp(q, cent, count, assign, length):   # centroid_scores kernel + torch ops
        cs = ops.centroid_scores(q, cent, count, scale=scale).amax(dim=2)
        a = assign.permute(0, 2, 1)
        inh = torch.gather(cs, -1, torch.where(a >= 0, a, 0).long())
        ok = (a >= 0) & ref.selectable_mask_ref(assign.shape[1], length, P, N_SINK,
                                                N_WIN)[:, None, :]
        return ref.top_ids(torch.where(ok, inh, -1e30), None, m)
    comp_ms, comp_call_ms = time_ms(comp, args)
    plain_ms, _ = time_ms(lambda *a: ref.centroid_candidates_ref(*a, m, scale, P, N_SINK, N_WIN),
                          args, iters=10)
    return {"name": "centroid_candidates",
            "shape": f"q({B},{KV},{G},{D}) cent({B},{N_CENT},{KV},2,{D}) "
                     f"assign({B},{N_PAGES},{KV}) m {m}",
            **rl.kernel_bound(kcost.centroid_candidates(B, KV, G, N_CENT, N_PAGES, D, m, 2)),
            "max_abs_err": 0.0, "tol": 0.0,
            "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "composition_ms": comp_ms, "composition_call_ms": comp_call_ms,
            "composition": "centroid_scores kernel + amax, gather, mask, stable sort (torch)",
            "library_ms": None, "library_call": "none: no single PyTorch call selects candidates"}


def check_page_summary(ops, ref, dev, gen):
    # (b, T): a continuous admission's prefill at the longest prompt and at one
    # that is not a power of two (B=1), the static batch's prefill (B=4), and
    # one decode page of every slot; each a prefix view of a longer tensor
    cases = ((1, CONTEXT, 40), (1, 7168, 40), (B, CONTEXT, 40), (B, P, 0))
    for dt in (torch.float32, torch.bfloat16):
        for b, T, extra in cases:
            full = torch.randn(b, T + extra, KV, D, generator=gen, device=dev).to(dt)
            k = full[:, :T]
            got = ops.page_summary(k, page_size=P)
            want = ref.page_summary_ref(k, P)
            torch.cuda.synchronize()
            require(got.dtype == dt and torch.equal(got, want),
                    f"page_summary {dt} B={b} T={T}: not exact (max |err| "
                    f"{(got.float() - want.float()).abs().max().item()})")
    dt = torch.bfloat16

    def timed(b):
        args = [(torch.randn(b, CONTEXT, KV, D, generator=gen, device=dev).to(dt),)
                for _ in range(copies_for(b * CONTEXT * KV * D * 2))]
        ms, call_ms = time_ms(lambda k: ops.page_summary(k, page_size=P), args)
        plain_ms, _ = time_ms(lambda k: ref.page_summary_ref(k, P), args, iters=10)
        lib_ms, _ = time_ms(lambda k: torch.aminmax(k.view(b, CONTEXT // P, P, KV, D), dim=2),
                            args)
        return {"shape": f"k({b},{CONTEXT},{KV},{D}) -> ({b},{CONTEXT // P},{KV},2,{D})",
                **rl.kernel_bound(kcost.page_summary(b, CONTEXT, KV, D, P, 2)), "kernel_ms": ms, "kernel_call_ms": call_ms,
                "plain_ms": plain_ms, "library_ms": lib_ms}

    # timed at a continuous admission's prefill (B=1), the main path's shape,
    # and at the static batch's (B=4) beside it
    return {"name": "page_summary", **timed(1), "static_batch": timed(B),
            "max_abs_err": 0.0, "tol": 0.0,
            "checked": [f"B={b} T={t}" for b, t, _ in cases],
            "library_call": "torch.aminmax over the page axis"}


FILL_QUANT = ((0, 0), (8, 0), (4, 0), (8, 16), (4, 32))   # (bits, quant_group_size)


def _pool_outputs(b, n_pages, dt, bits, group, dev, pinned=False, kv=KV, d=D):
    """Empty summ (b, n_pages, kv, 2, d) of dt and pool (b, n_pages, kv, 2, P,
    dp) of dt, or int8 with float32 scales (b, n_pages, kv, 2, n_g), as
    ``paging.init_kv_state`` lays them out; the pool and its scales on the
    card or pinned."""
    def alloc(shape, t):
        x = torch.zeros(shape, dtype=t)
        return x.pin_memory() if pinned else x.to(dev)
    summ = torch.zeros(b, n_pages, kv, 2, d, dtype=dt, device=dev)
    if not bits:
        return summ, alloc((b, n_pages, kv, 2, P, d), dt), None
    n_g = d // (group or d)
    return (summ, alloc((b, n_pages, kv, 2, P, d * bits // 8), torch.int8),
            alloc((b, n_pages, kv, 2, n_g), torch.float32))


def _quant_arg(pool, scale):
    """(bits, group) of a pool as ``quantize_block`` takes them."""
    return (8 if pool.shape[-1] == D else 4), D // scale.shape[-1]


def check_fill_pages(ops, ref, dev, gen):
    """fill_pages exact against its plain version (summaries, payload and
    scales; fp, int8 and int4; bf16 and fp32) at a continuous admission's
    shapes (B=1, T=8192 and 7168) and the static batch's (B=4, T=8192), K
    and V prefix views of a longer prompt, the outputs the first pages of
    the state's; and the prefill's pool fill into a pinned pool (a staging
    block, one copy a row) equal to it into a device pool. Timed at B=1 and
    B=4 (fp pool, and int8 at B=1) beside its bound, its plain version, the
    composition it replaces (stack of transposes, the quantizer, the
    summary kernel and the summaries' write) and torch.aminmax."""
    from repro_torch.core import paging
    from repro_torch.quant.quantizers import quantize_block
    cases = ((1, CONTEXT), (1, 7168), (B, CONTEXT))
    for dt in (torch.float32, torch.bfloat16):
        for b, T in cases:
            k = torch.randn(b, T + 40, KV, D, generator=gen, device=dev).to(dt)[:, :T]
            v = torch.randn(b, T + 40, KV, D, generator=gen, device=dev).to(dt)[:, :T]
            k[:, 64:96] = 0                            # a zero page: scale 1
            v[:, 64:96] = 0
            n = T // P
            for bits, group in FILL_QUANT:
                got = _pool_outputs(b, N_PAGES, dt, bits, group, dev)
                want = tuple(None if t is None else t.clone() for t in got)
                ops.fill_pages(k, v, *(None if t is None else t[:, :n] for t in got))
                ref.fill_pages_ref(k, v, *(None if t is None else t[:, :n] for t in want))
                torch.cuda.synchronize()
                for what, x, y in zip(("summ", "pool", "scale"), got, want):
                    require(x is None or torch.equal(x, y),
                            f"fill_pages {dt} int{bits or 0} g{group} B={b} T={T}: {what} "
                            "not exact")
                if b == 1 and T == CONTEXT:
                    # the prefill's pool fill into a pinned pool equals it into a device one
                    st = {}
                    for pinned in (False, True):
                        summ, pool, scale = _pool_outputs(1, N_PAGES, dt, bits, group, dev,
                                                          pinned)
                        st[pinned] = {"summ": summ, "pool": pool,
                                      **({} if scale is None else {"pool_scale": scale}),
                                      **{key: torch.zeros(1, N_WIN if key.startswith("win")
                                                          else N_SINK, KV, D, dtype=dt,
                                                          device=dev)
                                         for key in ("sink_k", "sink_v", "win_k", "win_v")},
                                      "win_pos": torch.zeros(1, N_WIN, dtype=torch.int32,
                                                             device=dev)}
                        paging.prefill_fill_pool(st[pinned], k, v, T)
                    torch.cuda.synchronize()
                    require(st[True]["pool"].is_pinned(), "the pinned pool is not pinned")
                    for key, x in st[False].items():
                        require(torch.equal(st[True][key].to(dev), x),
                                f"fill_pages {dt} int{bits or 0}: the pinned pool's {key} "
                                "differs from the device pool's")
            del k, v
    dt = torch.bfloat16

    def composition(k, v, summ, pool, scale):
        """The prefill's pool fill before fill_pages: the HND block by a
        stack of transposes (quantized under the quantized tier), the
        summary kernel, and the summaries' write."""
        b, n = pool.shape[:2]
        kp = k[:, :n * P].unflatten(1, (n, P))
        vp = v[:, :n * P].unflatten(1, (n, P))
        hnd = torch.stack([kp.transpose(2, 3), vp.transpose(2, 3)], dim=3)
        if scale is None:
            pool.copy_(hnd.to(pool.dtype).contiguous())
        else:
            q, sc = quantize_block(hnd, *_quant_arg(pool, scale))
            pool.copy_(q.contiguous())
            scale.copy_(sc.contiguous())
        summ.copy_(ops.page_summary(k[:, :n * P], page_size=P).to(summ.dtype))

    def timed(b, bits):
        n = CONTEXT // P
        bound = rl.kernel_bound(kcost.fill_pages(b, n, P, KV, D, 2, 2, bits=bits,
                                              n_g=1 if bits else 0))
        args = []
        for _ in range(copies_for(bound["bound_bytes"])):
            k = torch.randn(b, CONTEXT, KV, D, generator=gen, device=dev).to(dt)
            v = torch.randn(b, CONTEXT, KV, D, generator=gen, device=dev).to(dt)
            # the staging block of a pinned pool: exactly the filled pages
            args.append((k, v) + _pool_outputs(b, n, dt, bits, 0, dev))
        ms, call_ms = time_ms(ops.fill_pages, args)
        plain_ms, _ = time_ms(ref.fill_pages_ref, args, iters=10)
        comp_ms, comp_call_ms = time_ms(composition, args)
        lib_ms, _ = time_ms(lambda k, *_: torch.aminmax(k.unflatten(1, (n, P)), dim=2), args)
        return {"shape": f"k,v({b},{CONTEXT},{KV},{D}) -> block({b},{n},{KV},2,{P},{D}) "
                         f"{'bf16' if not bits else f'int{bits}'} + summ",
                **bound, "kernel_ms": ms, "kernel_call_ms": call_ms,
                "plain_ms": plain_ms, "composition_ms": comp_ms,
                "composition_call_ms": comp_call_ms, "library_ms": lib_ms}

    # timed at a continuous admission (B=1), the main path's shape, and at
    # the static batch's (B=4); int8 at B=1
    return {"name": "fill_pages", **timed(1, 0), "static_batch": timed(B, 0),
            "int8": timed(1, 8), "max_abs_err": 0.0, "tol": 0.0,
            "checked": [f"B={b} T={t}" for b, t in cases] + ["pinned pool via prefill_fill_pool"],
            "composition": "stack of transposes (+ quantize_block) + page_summary kernel + "
                           "the summaries' write",
            "library_call": "torch.aminmax over the page axis (the summary part)"}


def _host_branch_completion(ops, win_k, win_v, length_host, summ, pool, scale=None):
    """What complete_page replaces: append_token's former page completion.
    The rows that complete a page are picked on the host from a CPU
    copy of the post-append lengths; then two pinned index uploads, two
    advanced-index gathers from the ring, a stack of transposes, the
    quantizer under the quantized tier, one copy a row into the pool (and
    its scales), the summary kernel and a scatter into the summaries."""
    from repro_torch.quant.quantizers import quantize_block
    new_len = [int(x) for x in length_host]
    rows = [b for b in range(len(new_len)) if new_len[b] % P == 0]
    if not rows:
        return
    pages = [new_len[b] // P - 1 for b in rows]

    dev = win_k.device

    def ids(vals):
        return torch.tensor(vals, dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    pages_d = ids(pages)
    slot = (pages_d[:, None] * P + torch.arange(P, device=dev)) % win_k.shape[1]
    ridx = ids(rows)
    pk = win_k[ridx[:, None], slot]
    pv = win_v[ridx[:, None], slot]
    hnd = torch.stack([pk.transpose(1, 2), pv.transpose(1, 2)], dim=2)
    if scale is None:
        blocks, scs = hnd.to(pool.dtype).contiguous(), None
    else:
        blocks, scs = quantize_block(hnd, *_quant_arg(pool, scale))
    for i, (b, pg) in enumerate(zip(rows, pages)):
        pool[b, pg].copy_(blocks[i], non_blocking=True)
        if scs is not None:
            scale[b, pg].copy_(scs[i], non_blocking=True)
    summ[ridx, pages_d] = ops.page_summary(pk, page_size=P)[:, 0].to(summ.dtype)


def check_complete_page(ops, ref, dev, gen):
    """complete_page exact against its plain version (summaries, payload and
    scales; fp, int8 and int4; bf16 and fp32; a device and a pinned pool)
    on the main path's 4 slots, with post-append lengths that complete no
    page, pages in some rows and a page in every row, over the main path's
    ring and a 150-slot one where a page wraps the ring's end; a row that
    completes nothing keeps every byte of its pool, scales and summaries.
    Timed at bf16 to the pinned pool: a step where every row completes a
    page (beside the host-branch completion it replaced, in the same call) and one
    where none does."""
    lengths = ([8200, 6150, 4101, 7170], [8224, 6150, 4128, 7170], [8224, 6176, 4128, 7200])
    for dt in (torch.float32, torch.bfloat16):
        for n_win in (N_WIN, 150):                 # 150: page 192 wraps (slots 144..149, 0..25)
            win_k = torch.randn(B, n_win, KV, D, generator=gen, device=dev).to(dt)
            win_v = torch.randn(B, n_win, KV, D, generator=gen, device=dev).to(dt)
            for bits, group in FILL_QUANT:
                for pinned in (False, True):
                    outs = _pool_outputs(B, N_PAGES, dt, bits, group, dev, pinned)
                    for t in outs:                 # old bytes, to be kept or replaced
                        if t is not None:
                            t.copy_(torch.randint(-50, 50, t.shape, generator=gen, device=dev))
                    for ls in lengths:
                        length = torch.tensor(ls, dtype=torch.int32, device=dev)
                        want = tuple(None if t is None else t.to(dev, copy=True) for t in outs)
                        before = tuple(None if t is None else t.clone() for t in outs)
                        ops.complete_page(win_k, win_v, length, *outs)
                        ref.complete_page_ref(win_k, win_v, length, *want)
                        torch.cuda.synchronize()
                        what = f"complete_page {dt} int{bits or 0} g{group} ring {n_win} " \
                               f"{'pinned' if pinned else 'device'} lengths {ls}"
                        for name, x, y, x0 in zip(("summ", "pool", "scale"), outs, want, before):
                            if x is None:
                                continue
                            require(torch.equal(x.to(dev), y), f"{what}: {name} not exact")
                            for r, n in enumerate(ls):
                                require(n % P == 0 or torch.equal(x[r], x0[r]),
                                        f"{what}: row {r} completed nothing but its {name} "
                                        "changed")
                    del outs, want, before
    dt = torch.bfloat16
    win_k = torch.randn(B, N_WIN, KV, D, generator=gen, device=dev).to(dt)
    win_v = torch.randn(B, N_WIN, KV, D, generator=gen, device=dev).to(dt)
    every = torch.tensor(lengths[2], dtype=torch.int32, device=dev)
    none = torch.tensor(lengths[0], dtype=torch.int32, device=dev)
    host = _pool_outputs(B, N_PAGES, dt, 0, 0, dev, pinned=True)
    device = _pool_outputs(B, N_PAGES, dt, 0, 0, dev)
    ms, call_ms = time_ms(ops.complete_page, [(win_k, win_v, every) + host])
    none_ms, none_call_ms = time_ms(ops.complete_page, [(win_k, win_v, none) + host])
    dev_ms, _ = time_ms(ops.complete_page, [(win_k, win_v, every) + device])
    plain_ms, _ = time_ms(ref.complete_page_ref, [(win_k, win_v, every) + device], iters=10)
    every_host = every.cpu()
    comp_ms, comp_call_ms = time_ms(
        lambda *a: _host_branch_completion(ops, win_k, win_v, every_host, *a), [host])
    slot = (torch.tensor([n // P - 1 for n in lengths[2]], device=dev)[:, None] * P
            + torch.arange(P, device=dev)) % N_WIN
    pk = win_k[torch.arange(B, device=dev)[:, None], slot]       # (B, p, kv, d)
    lib_ms, _ = time_ms(lambda x: torch.aminmax(x, dim=1), [(pk,)])
    # every row completing: the blocks to the host; no row: the lengths only
    return {"name": "complete_page",
            "shape": f"rings({B},{N_WIN},{KV},{D}) -> pinned pool({B},{N_PAGES},{KV},2,{P},{D}), "
                     "every row completing",
            **rl.kernel_bound(kcost.complete_page(B, P, KV, D, 2)),
            "bound_link": "PCIe for the pinned host pool",
            "kernel_ms": ms, "kernel_call_ms": call_ms, "device_pool_ms": dev_ms,
            "device_pool_bound_ms": rl.kernel_bound(kcost.complete_page(B, P, KV, D, 2,
                                                                     host=False))["bound_ms"],
            "no_completion": {"kernel_ms": none_ms, "kernel_call_ms": none_call_ms,
                              "bound_ms": rl.kernel_bound(kcost.complete_page(
                                  B, P, KV, D, 2, rows=0))["bound_ms"]},
            "plain_ms": plain_ms, "composition_ms": comp_ms, "composition_call_ms": comp_call_ms,
            "composition": "the former host-branch completion: host pick, 2 pinned index uploads, "
                           "ring gathers, stack, a copy_ a row, page_summary kernel, scatter",
            "library_ms": lib_ms, "library_call": "torch.aminmax over the page's tokens "
                                                  "(the summary part)",
            "max_abs_err": 0.0, "tol": 0.0,
            "checked": [f"lengths {ls}" for ls in lengths]}


def _prefill_inputs(gen, dev, dt, b, h, kv, t, d):
    """q, k, v as the model hands them over: (b, t, heads, d) tensors seen
    as (b, heads, t, d) views."""
    q = torch.randn(b, t, h, d, generator=gen, device=dev).to(dt).transpose(1, 2)
    k = torch.randn(b, t, kv, d, generator=gen, device=dev).to(dt).transpose(1, 2)
    v = torch.randn(b, t, kv, d, generator=gen, device=dev).to(dt).transpose(1, 2)
    return q, k, v


def check_flash_prefill(ops, ref, dev, gen):
    errs = {}
    lib_prec = None
    cases = [  # (name, B, H, kv, T, d, window, softcap)
        # a continuous admission (the main path's shape) at the longest
        # prompt and at one that is not a power of two; the static batch
        ("admit 8192", 1, H, KV, CONTEXT, D, None, None),
        ("admit 7168", 1, H, KV, 7168, D, None, None),
        ("static", B, H, KV, CONTEXT, D, None, None),
        ("window", 1, 8, 2, 1000, D, 256, None),
        ("softcap", 2, 4, 2, 777, 64, None, 30.0),
    ]
    for name, b, h, kv, t, d, window, cap in cases:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = _prefill_inputs(gen, dev, dt, b, h, kv, t, d)
            scale = 1.0 / math.sqrt(d)
            got = ops.flash_prefill(q, k, v, scale=scale, causal=True, window=window, softcap=cap)
            want = ref.flash_prefill_ref(q, k, v, scale, True, window, cap)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            require(got.dtype == dt and torch.allclose(got.float(), want.float(), **TOL[dt]),
                    f"flash_prefill {name} {dt}: max |err| {err} (max |want| "
                    f"{want.float().abs().max().item()}), tolerance {TOL[dt]}")
            errs[(name, dt)] = err
            if name == "admit 8192" and dt == torch.bfloat16:
                sdpa = torch.nn.functional.scaled_dot_product_attention(
                    *(x.contiguous() for x in (q, k, v)), is_causal=True, scale=scale,
                    enable_gqa=True)
                lib_prec = _library_precision(sdpa, want, dt)
                del sdpa
            del q, k, v, got, want
    dt = torch.bfloat16
    scale = 1.0 / math.sqrt(D)

    def timed(b):
        args = [_prefill_inputs(gen, dev, dt, b, H, KV, CONTEXT, D)]
        ms, call_ms = time_ms(lambda q, k, v: ops.flash_prefill(q, k, v, scale=scale), args,
                              iters=3)
        plain_ms, _ = time_ms(lambda q, k, v: ref.flash_prefill_ref(q, k, v, scale), args,
                              iters=1)
        sdpa_args = [tuple(x.contiguous() for x in args[0])]
        lib_ms, _ = time_ms(lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True), sdpa_args, iters=10)
        return {"shape": f"q({b},{H},{CONTEXT},{D}) kv({b},{KV},{CONTEXT},{D}) causal",
                **rl.kernel_bound(kcost.flash_prefill(b, H, KV, CONTEXT, CONTEXT, D, 2)),
                "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms}

    # timed at a continuous admission (B=1), the main path's shape, and at
    # the static batch's (B=4) beside it
    return {"name": "flash_prefill", **timed(1), "static_batch": timed(B),
            "extension": check_flash_prefill_extension(ops, ref, dev, gen),
            "bidirectional": check_flash_prefill_bidirectional(ops, ref, dev, gen),
            "max_abs_err": errs[("admit 8192", torch.bfloat16)],
            "max_abs_err_fp32": errs[("admit 8192", torch.float32)],
            "max_abs_err_cases": {f"{n} {str(t).split('.')[-1]}": e for (n, t), e in errs.items()},
            "tol": TOL[torch.bfloat16], "tol_fp32": TOL[torch.float32],
            "library_call": "scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
            **lib_prec}


# whisper-tiny's encoder: 1500 frames, 6/6 heads at d_head 64
ENC_FRAMES, ENC_HEADS, ENC_D = 1500, 6, 64


def check_flash_prefill_bidirectional(ops, ref, dev, gen):
    """flash_prefill with ``causal=False`` (every query sees every key: the
    encoder of an encoder-decoder) against its plain version within TOL in
    bf16 and fp32 at whisper-tiny's encoder shape, B=1 and T=1500 (no
    multiple of the 64-key tile or the 128-row block), at T=1536 (a
    multiple) and at B=4; timed at B=1, T=1500 beside its bound, the plain
    version and SDPA without a mask (the same function), with SDPA's own
    max |error| against the plain version."""
    errs = {}
    h, d, scale = ENC_HEADS, ENC_D, 1.0 / math.sqrt(ENC_D)
    for name, b, t in (("1500", 1, ENC_FRAMES), ("1536", 1, 1536), ("B=4 1500", B, ENC_FRAMES)):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = _prefill_inputs(gen, dev, dt, b, h, h, t, d)
            errs[f"{name} {str(dt).split('.')[-1]}"] = _held(
                f"flash_prefill bidirectional {name}",
                ops.flash_prefill(q, k, v, scale=scale, causal=False),
                ref.flash_prefill_ref(q, k, v, scale, False), dt)
            del q, k, v
    dt, t = torch.bfloat16, ENC_FRAMES
    args = [_prefill_inputs(gen, dev, dt, 1, h, h, t, d)
            for _ in range(copies_for(4 * t * h * d * 2))]
    ms, call_ms = time_ms(lambda q, k, v: ops.flash_prefill(q, k, v, scale=scale, causal=False),
                          args)
    plain_ms, _ = time_ms(lambda q, k, v: ref.flash_prefill_ref(q, k, v, scale, False), args,
                          iters=10)
    sdpa = lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, scale=scale)
    sdpa_args = [tuple(x.contiguous() for x in a) for a in args]
    lib_ms, _ = time_ms(sdpa, sdpa_args)
    q, k, v = args[0]
    lib_prec = _library_precision(sdpa(*sdpa_args[0]), ref.flash_prefill_ref(q, k, v, scale,
                                                                             False), dt)
    return {"shape": f"q(1,{h},{t},{d}) kv(1,{h},{t},{d}) bidirectional",
            **rl.kernel_bound(kcost.flash_prefill(1, h, h, t, t, d, 2, causal=False)),
            "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_call": "scaled_dot_product_attention(q, k, v)",
            "max_abs_err": errs["1500 bfloat16"], "max_abs_err_fp32": errs["1500 float32"],
            "max_abs_err_cases": errs, **lib_prec}


def check_flash_prefill_extension(ops, ref, dev, gen):
    """flash_prefill's extension form (Tq < Tk, query row i at absolute
    position Tk - Tq + i: a chunk after the first, a prefix-cache hit's
    suffix) against its plain version within TOL in bf16 and fp32, timed at
    Tq=2048 over Tk=8192 beside its bound and SDPA with a lower-right causal
    bias (``is_causal=True`` aligns top-left: another function)."""
    from torch.nn.attention.bias import causal_lower_right
    errs = {}
    cases = [  # (name, B, H, kv, Tq, Tk, d, window, softcap)
        ("2048/8192", 1, H, KV, 2048, CONTEXT, D, None, None),
        # a ragged chunk after a page-aligned prefix-cache hit
        ("1000/7200", 1, H, KV, 1000, 7168 + P, D, None, None),
        ("1/4096", 1, H, KV, 1, 4096, D, None, None),
        ("window", 1, 8, 2, 300, 1000, D, 256, None),
        ("softcap", 2, 4, 2, 200, 777, 64, None, 30.0),
    ]
    for name, b, h, kv, tq, tk, d, window, cap in cases:
        for dt in (torch.float32, torch.bfloat16):
            q = _prefill_inputs(gen, dev, dt, b, h, kv, tq, d)[0]
            _, k, v = _prefill_inputs(gen, dev, dt, b, h, kv, tk, d)
            scale = 1.0 / math.sqrt(d)
            got = ops.flash_prefill(q, k, v, scale=scale, causal=True, window=window, softcap=cap)
            want = ref.flash_prefill_ref(q, k, v, scale, True, window, cap)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            require(got.dtype == dt and got.shape == q.shape
                    and torch.allclose(got.float(), want.float(), **TOL[dt]),
                    f"flash_prefill extension {name} {dt}: max |err| {err}, tolerance {TOL[dt]}")
            errs[f"{name} {str(dt).split('.')[-1]}"] = err
            del q, k, v, got, want
    dt, tq, tk = torch.bfloat16, 2048, CONTEXT
    scale = 1.0 / math.sqrt(D)
    args = [(_prefill_inputs(gen, dev, dt, 1, H, KV, tq, D)[0],
             *_prefill_inputs(gen, dev, dt, 1, H, KV, tk, D)[1:])]
    ms, call_ms = time_ms(lambda q, k, v: ops.flash_prefill(q, k, v, scale=scale), args, iters=5)
    plain_ms, _ = time_ms(lambda q, k, v: ref.flash_prefill_ref(q, k, v, scale), args, iters=1)
    bias = causal_lower_right(tq, tk)
    q, k, v = args[0]
    # the yardstick's K/V expanded to the query heads, contiguous
    sdpa_args = [(q.contiguous(), k.repeat_interleave(G, dim=1).contiguous(),
                  v.repeat_interleave(G, dim=1).contiguous())]
    sdpa = lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=bias, scale=scale)
    lib_ms, _ = time_ms(sdpa, sdpa_args, iters=10)
    lib_prec = _library_precision(sdpa(*sdpa_args[0]), ref.flash_prefill_ref(q, k, v, scale), dt)
    return {"shape": f"q(1,{H},{tq},{D}) kv(1,{KV},{tk},{D}) causal lower-right",
            **rl.kernel_bound(kcost.flash_prefill(1, H, KV, tq, tk, D, 2)),
            "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "library_call": f"scaled_dot_product_attention(attn_mask=causal_lower_right({tq}, "
                            f"{tk})), K/V expanded to {H} heads",
            "max_abs_err": errs["2048/8192 bfloat16"],
            "max_abs_err_fp32": errs["2048/8192 float32"], "max_abs_err_cases": errs,
            **lib_prec}



# ---------------------------------------------------------------------------
# phase 3: the page-sharded fused step's forms (core/sharded_retrieval), at
# the main path's shapes over MESH_SHARDS page shards of a MESH_PAGES-page pool
# ---------------------------------------------------------------------------
MESH_SHARDS = 4
MESH_PAGES = -(-N_PAGES // MESH_SHARDS) * MESH_SHARDS       # 260: pool_pad_pages 4
MESH_SEL = N_SEL * 2 // MESH_SHARDS                         # 28: sharded_overselect 2
LSE_ATOL = 1e-5                                             # fp32 log-sum-exp


def _lse_merge(parts):
    """(o, lse) partials merged by log-sum-exp, as the fused step does."""
    mx = parts[0][1]
    for _, lse in parts[1:]:
        mx = torch.maximum(mx, lse)
    num = den = 0.0
    for o, lse in parts:
        w = torch.exp(lse - mx)
        num = num + o.float() * w[..., None]
        den = den + w
    return num / den[..., None]


def _efficient_lse_inputs(q, k, v, pos, cur):
    """Paged attention's inputs as the memory-efficient SDPA op takes them:
    K/V heads expanded to the G query heads and the mask as an additive
    bias of the inputs' dtype (0 or -inf)."""
    qq, kk, vv, mask = _sdpa_paged_inputs(q, k, v, pos, cur)
    bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device)
    return qq, kk, vv, bias.masked_fill_(~mask, float("-inf"))


def _efficient_lse(q, k, v, bias, scale):
    """One library call for attention and its log-sum-exp: (o (B, H, 1, d)
    in q's dtype, lse (B, H) float32)."""
    o, lse = torch.ops.aten._scaled_dot_product_efficient_attention(
        q, k, v, bias, True, scale=scale)[:2]
    return o, lse[..., 0]


def check_paged_attention_lse(ops, ref, dev, gen):
    """paged_attention_lse against its plain version: the float32 output
    within TOL's fp32 entry (both are unrounded float32 sums of the same
    products, bf16 inputs too) and the log-sum-exp within LSE_ATOL at fp32
    (TOL's fp32 entry at bf16); and MESH_SHARDS page shards' (o, lse), each
    its own launch over its slice of the pages, merged and rounded to the
    inputs' dtype against one whole launch, within TOL."""
    out, lse_err, merge_err, lib_prec = {}, {}, {}, None
    n = L // P
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(B, KV, G, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, KV, n, P, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, KV, n, P, D, generator=gen, device=dev).to(dt)
        pos = torch.randint(-1, CONTEXT + 8, (B, KV, n, P), generator=gen, device=dev,
                            dtype=torch.int32)
        pos[:, :, 5] = -1                             # a fully masked page
        cur = torch.full((B,), CONTEXT, dtype=torch.int32, device=dev)
        scale = 1.0 / math.sqrt(D)
        got, got_lse = ops.paged_attention_lse(q, k, v, pos, cur, scale=scale)
        want, want_lse = ref.paged_attention_lse_ref(q, k, v, pos, cur, scale)
        torch.cuda.synchronize()
        # both outputs are float32 sums of the same products (unrounded)
        o_tol = TOL[torch.float32]
        out[dt] = (got - want).abs().max().item()
        require(got.dtype == torch.float32 and torch.allclose(got, want, **o_tol),
                f"paged_attention_lse {dt}: output max |err| {out[dt]}, tolerance {o_tol}")
        lse_err[dt] = (got_lse - want_lse).abs().max().item()
        lse_tol = dict(atol=LSE_ATOL, rtol=0.0) if dt == torch.float32 else TOL[torch.float32]
        require(torch.allclose(got_lse, want_lse, **lse_tol),
                f"paged_attention_lse {dt}: lse max |err| {lse_err[dt]}, tolerance {lse_tol}")
        whole = ops.paged_attention(q, k, v, pos, cur, scale=scale)
        cuts = [n * j // MESH_SHARDS for j in range(MESH_SHARDS + 1)]
        parts = [ops.paged_attention_lse(q, k[:, :, a:b].contiguous(), v[:, :, a:b].contiguous(),
                                         pos[:, :, a:b].contiguous(), cur, scale=scale)
                 for a, b in zip(cuts, cuts[1:])]
        merged = _lse_merge(parts)
        torch.cuda.synchronize()
        merge_err[dt] = (merged.to(dt).float() - whole.float()).abs().max().item()
        require(torch.allclose(merged.to(dt).float(), whole.float(), **TOL[dt]),
                f"{MESH_SHARDS} page shards merged by lse {dt}: max |err| {merge_err[dt]} "
                f"against one launch, tolerance {TOL[dt]}")
        if dt == torch.bfloat16:
            lib_o, lib_lse = _efficient_lse(*_efficient_lse_inputs(q, k, v, pos, cur), scale)
            lib_prec = _library_precision(lib_o.reshape(B, KV, G, D), want, dt)
            lib_prec["library_lse_max_abs_err"] = (
                lib_lse.reshape(B, KV, G) - want_lse).abs().max().item()
    dt = torch.bfloat16
    args = []
    for _ in range(copies_for(2 * B * KV * L * D * 2)):
        q = torch.randn(B, KV, G, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, KV, n, P, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, KV, n, P, D, generator=gen, device=dev).to(dt)
        pos = torch.arange(L, dtype=torch.int32, device=dev).reshape(1, 1, n, P)
        args.append((q, k, v, pos.expand(B, KV, -1, -1).contiguous(),
                     torch.full((B,), L - 1, dtype=torch.int32, device=dev)))
    scale = 1.0 / math.sqrt(D)
    ms, call_ms = time_ms(lambda *a: ops.paged_attention_lse(*a, scale=scale), args)
    plain_ms, _ = time_ms(lambda *a: ref.paged_attention_lse_ref(*a, scale), args, iters=10)
    # yardstick: the memory-efficient SDPA op with its log-sum-exp, an
    # additive mask over the same keys, timed on inputs already expanded to
    # the G query heads
    lib_args = [_efficient_lse_inputs(*a) for a in args]
    lib_ms, _ = time_ms(lambda q, k, v, b: _efficient_lse(q, k, v, b, scale), lib_args)
    return {"name": "paged_attention_lse",
            "shape": f"q({B},{KV},{G},{D}) kv({B},{KV},{n},{P},{D}) -> o, lse({B},{KV},{G})",
            **rl.kernel_bound(kcost.paged_attention_lse(B, KV, G, n, P, D, 2)),
            "max_abs_err": out[torch.bfloat16], "max_abs_err_fp32": out[torch.float32],
            "lse_max_abs_err": lse_err[torch.bfloat16], "lse_max_abs_err_fp32":
            lse_err[torch.float32], "lse_tol_fp32": LSE_ATOL,
            "merge_max_abs_err": merge_err[torch.bfloat16],
            "merge_max_abs_err_fp32": merge_err[torch.float32],
            "merge": f"{MESH_SHARDS} page shards merged by lse against one launch",
            "tol": TOL[torch.float32], "merge_tol": TOL[torch.bfloat16],
            "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "library_call": "aten._scaled_dot_product_efficient_attention(additive mask, "
                            "compute_log_sumexp=True)", **lib_prec}


def check_select_pages_shard(ops, ref, dev, gen):
    """select_pages_shard against its plain version on each of MESH_SHARDS
    page shards of a MESH_PAGES-page pool (page offset, global ids and
    validity): ids exact on the designed inputs (far apart, forced ties,
    probabilities underflowing to 0.0) in every pooling mode at fp32 and
    bf16, the kept ids' pooled values within 2e-5."""
    from repro_torch.launch.select_bench import select_inputs
    scale = 1.0 / math.sqrt(D)
    n_loc = MESH_PAGES // MESH_SHARDS
    tol = TOL[torch.float32]
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for mode in SELECT_MODES:
            for kind in ("distinct", "tie", "underflow"):
                q, summ, length = select_inputs(kind, B, KV, G, D, MESH_PAGES, N_SEL, dt, gen,
                                                dev)
                for j in range(MESH_SHARDS):
                    part = summ[:, j * n_loc:(j + 1) * n_loc].contiguous()
                    kw = dict(n_sel=MESH_SEL, scale=scale, page_size=P, n_sink=N_SINK,
                              n_window=N_WIN, mode=mode)
                    idx, top = ops.select_pages_shard(q, part, length, page_lo=j * n_loc, **kw)
                    want_idx, want_top = ref.select_pages_shard_ref(
                        q, part, length, MESH_SEL, scale, P, N_SINK, N_WIN, mode, j * n_loc)
                    torch.cuda.synchronize()
                    what = f"select_pages_shard {kind} {mode} {dt} shard {j}"
                    require(torch.equal(idx, want_idx), f"{what}: page ids differ")
                    e = (top - want_top).abs().max().item()
                    require(torch.allclose(top, want_top, **tol),
                            f"{what}: kept scores max |err| {e}, tolerance {tol}")
                    err = max(err, e)
    dt, mode = torch.bfloat16, "mean_softmax"
    args = []
    for _ in range(copies_for(B * n_loc * KV * 2 * D * 2)):
        q, summ, length = select_inputs("random", B, KV, G, D, MESH_PAGES, N_SEL, dt, gen, dev)
        args.append((q, summ[:, n_loc:2 * n_loc].contiguous(), length))
    kw = dict(page_lo=n_loc, n_sel=MESH_SEL, scale=scale, page_size=P, n_sink=N_SINK,
              n_window=N_WIN, mode=mode)
    ms, call_ms = time_ms(lambda q, s, n: ops.select_pages_shard(q, s, n, **kw), args)
    plain_ms, _ = time_ms(lambda q, s, n: ref.select_pages_shard_ref(
        q, s, n, MESH_SEL, scale, P, N_SINK, N_WIN, mode, n_loc), args, iters=10)
    return {"name": "select_pages_shard",
            "shape": f"q({B},{KV},{G},{D}) summ({B},{n_loc},{KV},2,{D}) page_lo {n_loc} "
                     f"n_sel {MESH_SEL} MeanS",
            **rl.kernel_bound(kcost.select_pages_shard(B, KV, G, n_loc, D, MESH_SEL, 2)),
            "max_abs_err": err, "tol": tol, "ids": "exact",
            "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": None, "library_call": "none: no single PyTorch call selects pages"}


def check_complete_page_shard(ops, ref, dev, gen):
    """complete_page_shard exact against its plain version on each of
    MESH_SHARDS page shards (device and pinned pool, fp32 and bf16): the
    four rows complete pages that lie in different shards, each shard
    writes only the rows whose page is in its range, and every other row
    keeps its bytes. Timed at bf16 into a pinned shard with one row
    completing there."""
    n_loc = MESH_PAGES // MESH_SHARDS
    # pages 256, 192, 128 and 64 complete: shards 3, 2, 1 and 0
    lengths = torch.tensor([257 * P, 193 * P, 129 * P, 65 * P], dtype=torch.int32, device=dev)
    owner = [(int(n) // P - 1) // n_loc for n in lengths.tolist()]
    for dt in (torch.float32, torch.bfloat16):
        win_k = torch.randn(B, N_WIN, KV, D, generator=gen, device=dev).to(dt)
        win_v = torch.randn(B, N_WIN, KV, D, generator=gen, device=dev).to(dt)
        for pinned in (False, True):
            for j in range(MESH_SHARDS):
                summ, pool, _ = _pool_outputs(B, n_loc, dt, 0, 0, dev, pinned)
                for t in (summ, pool):
                    t.copy_(torch.randint(-50, 50, t.shape, generator=gen, device=dev))
                want = (summ.clone(), pool.to(dev, copy=True))
                before = (summ.clone(), pool.clone())
                ops.complete_page_shard(win_k, win_v, lengths, summ, pool, page_lo=j * n_loc)
                ref.complete_page_ref(win_k, win_v, lengths, *want, page_lo=j * n_loc)
                torch.cuda.synchronize()
                what = f"complete_page_shard {dt} {'pinned' if pinned else 'device'} shard {j}"
                for name, x, y, x0 in zip(("summ", "pool"), (summ, pool), want, before):
                    require(torch.equal(x.to(dev), y), f"{what}: {name} not exact")
                    for r in range(B):
                        require(owner[r] == j or torch.equal(x[r], x0[r]),
                                f"{what}: row {r}'s page lies in shard {owner[r]}, yet its "
                                f"{name} changed")
    dt = torch.bfloat16
    win_k = torch.randn(B, N_WIN, KV, D, generator=gen, device=dev).to(dt)
    win_v = torch.randn(B, N_WIN, KV, D, generator=gen, device=dev).to(dt)
    host = _pool_outputs(B, n_loc, dt, 0, 0, dev, pinned=True)[:2]
    device = _pool_outputs(B, n_loc, dt, 0, 0, dev)[:2]
    ms, call_ms = time_ms(lambda *a: ops.complete_page_shard(*a, page_lo=3 * n_loc),
                          [(win_k, win_v, lengths) + host])
    plain_ms, _ = time_ms(lambda *a: ref.complete_page_ref(*a, page_lo=3 * n_loc),
                          [(win_k, win_v, lengths) + device], iters=10)
    slot = (torch.tensor([256], device=dev)[:, None] * P + torch.arange(P, device=dev)) % N_WIN
    pk = win_k[:1, slot[0]]                                        # (1, p, kv, d)
    lib_ms, _ = time_ms(lambda x: torch.aminmax(x, dim=1), [(pk,)])
    return {"name": "complete_page_shard",
            "shape": f"rings({B},{N_WIN},{KV},{D}) -> pinned shard pool({B},{n_loc},{KV},2,{P},"
                     f"{D}) page_lo {3 * n_loc}, one row completing there",
            **rl.kernel_bound(kcost.complete_page_shard(B, P, KV, D, 2, rows=1)),
            "bound_link": "PCIe for the pinned host pool",
            "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_call": "torch.aminmax over the page's tokens "
                                                  "(the summary part)",
            "max_abs_err": 0.0, "tol": 0.0}

# ---------------------------------------------------------------------------
# phase 3, the served archs' shapes: each kernel at the head layouts, head
# widths, softcap and window of qwen25-7b, smollm-360m, gemma2-2b,
# stablelm-3b, deepseek-moe-16b, llama4-scout-17b-a16e and
# jamba-1.5-large-398b, against its plain version, timed beside its bound
# ---------------------------------------------------------------------------
# the shard layouts of KV-head-group tensor parallelism (phase 4f): each
# shard's retrieval kernels run at the arch's head counts divided by tp (the
# backbone's flash_prefill at the whole arch's, so it is not held here)
TP_SHAPES = {"llama31-8b@tp2": (16, 4, 128, None, None)}
ARCH_SHAPES = {   # arch -> (query heads, KV heads, d_head, softcap, sliding window)
    "qwen25-7b": (28, 4, 128, None, None),
    "smollm-360m": (15, 5, 64, None, None),
    "gemma2-2b": (8, 4, 256, 50.0, 4096),
    "stablelm-3b": (32, 32, 80, None, None),
    "deepseek-moe-16b": (16, 16, 128, None, None),
    "llama4-scout-17b-a16e": (40, 8, 128, None, None),
    "jamba-1.5-large-398b": (64, 8, 128, None, None),
    "whisper-tiny": (6, 6, 64, None, None),
    "internvl2-26b": (48, 8, 128, None, None),
    **TP_SHAPES,
}


def _held(name, got, want, dt):
    err = (got.float() - want.float()).abs().max().item()
    require(got.dtype == want.dtype and torch.allclose(got.float(), want.float(), **TOL[dt]),
            f"{name} {dt}: max |err| {err} (max |want| {want.float().abs().max().item()}), "
            f"tolerance {TOL[dt]}")
    return err


def check_paged_attention_shapes(ops, ref, dev, gen):
    """paged_attention at each arch's decode shape (B=4, L=2080 as the main
    path's budget), random positions (some past cur, a masked page) in
    fp32 and bf16 within TOL; timed at bf16 with every position valid
    beside its bound, its plain version and SDPA (none under a softcap)."""
    rows = {}
    for arch, (h, kv, d, cap, _) in ARCH_SHAPES.items():
        g, scale, n = h // kv, 1.0 / math.sqrt(d), L // P
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, kv, g, d, generator=gen, device=dev).to(dt)
            k = torch.randn(B, kv, n, P, d, generator=gen, device=dev).to(dt)
            v = torch.randn(B, kv, n, P, d, generator=gen, device=dev).to(dt)
            pos = torch.randint(-1, CONTEXT + 8, (B, kv, n, P), generator=gen, device=dev,
                                dtype=torch.int32)
            pos[:, :, 5] = -1
            cur = torch.full((B,), CONTEXT, dtype=torch.int32, device=dev)
            errs[dt] = _held(f"paged_attention {arch}", ops.paged_attention(
                q, k, v, pos, cur, scale=scale, softcap=cap),
                ref.paged_attention_ref(q, k, v, pos, cur, scale, cap), dt)
        dt = torch.bfloat16
        args = []
        for _ in range(copies_for(2 * B * kv * L * d * 2)):
            pos = torch.arange(L, dtype=torch.int32, device=dev).reshape(1, 1, n, P)
            args.append((torch.randn(B, kv, g, d, generator=gen, device=dev).to(dt),
                         torch.randn(B, kv, n, P, d, generator=gen, device=dev).to(dt),
                         torch.randn(B, kv, n, P, d, generator=gen, device=dev).to(dt),
                         pos.expand(B, kv, -1, -1).contiguous(),
                         torch.full((B,), L - 1, dtype=torch.int32, device=dev)))
        ms, call_ms = time_ms(lambda *a: ops.paged_attention(*a, scale=scale, softcap=cap), args)
        plain_ms, _ = time_ms(lambda *a: ref.paged_attention_ref(*a, scale, cap), args, iters=10)
        lib_ms = None
        if cap is None:
            lib_ms, _ = time_ms(lambda q, k, v, m: _sdpa(q, k, v, m, scale),
                                [_sdpa_paged_inputs(*a) for a in args])
        rows[arch] = {"shape": f"q({B},{kv},{g},{d}) kv({B},{kv},{n},{P},{d})"
                               + (f" softcap {cap:g}" if cap else ""),
                      **rl.kernel_bound(kcost.paged_attention(B, kv, g, n, P, d, 2)),
                      "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "max_abs_err": errs[torch.bfloat16],
                      "max_abs_err_fp32": errs[torch.float32]}
    return rows


def check_flash_prefill_shapes(ops, ref, dev, gen):
    """flash_prefill at each arch's continuous admission (B=1, T=8192) and in
    its extension form (Tq=2048 over Tk=8192), gemma2's with its window of
    4096 and softcap 50, stablelm's at d_head 80 (the d=128 tiles, the
    channels past 80 zero-filled), fp32 and bf16 within TOL; both forms
    timed at bf16 beside their bounds, the plain version and SDPA (causal,
    or with a lower-right causal bias for the extension; none for gemma2:
    SDPA has no softcap)."""
    from torch.nn.attention.bias import causal_lower_right
    rows = {}
    for arch, (h, kv, d, cap, window) in ARCH_SHAPES.items():
        if arch in TP_SHAPES:
            continue
        scale, errs = 1.0 / math.sqrt(d), {}
        for form, tq in (("prompt", CONTEXT), ("extension", 2048)):
            for dt in (torch.float32, torch.bfloat16):
                q = _prefill_inputs(gen, dev, dt, 1, h, kv, tq, d)[0]
                _, k, v = _prefill_inputs(gen, dev, dt, 1, h, kv, CONTEXT, d)
                errs[f"{form} {str(dt).split('.')[-1]}"] = _held(
                    f"flash_prefill {arch} {form}",
                    ops.flash_prefill(q, k, v, scale=scale, window=window, softcap=cap),
                    ref.flash_prefill_ref(q, k, v, scale, True, window, cap), dt)
                del q, k, v
        dt = torch.bfloat16
        for form, tq in (("prompt", CONTEXT), ("extension", 2048)):
            args = [(_prefill_inputs(gen, dev, dt, 1, h, kv, tq, d)[0],
                     *_prefill_inputs(gen, dev, dt, 1, h, kv, CONTEXT, d)[1:])]
            ms, call_ms = time_ms(lambda q, k, v: ops.flash_prefill(
                q, k, v, scale=scale, window=window, softcap=cap), args, iters=3)
            plain_ms, _ = time_ms(lambda q, k, v: ref.flash_prefill_ref(
                q, k, v, scale, True, window, cap), args, iters=1)
            q, k, v = args[0]
            lib_ms = None
            sdpa = torch.nn.functional.scaled_dot_product_attention
            if cap is None and form == "prompt":
                lib_ms, _ = time_ms(lambda q, k, v: sdpa(
                    q, k, v, is_causal=True, scale=scale, enable_gqa=True),
                    [tuple(x.contiguous() for x in args[0])], iters=10)
            elif cap is None:
                # lower-right causal bias over K/V expanded to the query heads,
                # as the llama-shape extension row
                bias = causal_lower_right(tq, CONTEXT)
                expanded = [(q, k.repeat_interleave(h // kv, dim=1).contiguous(),
                             v.repeat_interleave(h // kv, dim=1).contiguous())]
                lib_ms, _ = time_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=bias, scale=scale),
                                    expanded, iters=10)
                del expanded
            shape = (f"q(1,{h},{tq},{d}) kv(1,{kv},{CONTEXT},{d}) causal"
                     + (" lower-right" if form == "extension" else "")
                     + (f" window {window} softcap {cap:g}" if cap else ""))
            rows[arch if form == "prompt" else f"{arch} extension"] = {
                "shape": shape,
                **rl.kernel_bound(kcost.flash_prefill(1, h, kv, tq, CONTEXT, d, 2, window=window)),
                "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "max_abs_err": errs[f"{form} bfloat16"],
                "max_abs_err_cases": errs}
            del args, q, k, v
            torch.cuda.empty_cache()
    return rows


def check_select_pages_shapes(ops, ref, dev, gen):
    """select_pages at each arch's decode shape (B=4, 259 pages, n_sel 56):
    the per-query-head mode (Quest) with ids exactly equal on far-apart and
    forced-tie inputs and where fewer pages are selectable than n_sel (the
    invalid lanes keep jax.lax.top_k's ids, lower first), tie-aware on
    random ones; the pooled MeanS mode at the arch's G exact likewise, also
    with its invalid lanes kept (RaaS's seeding). Both modes timed at bf16
    beside their bounds and their plain versions."""
    from repro_torch.launch.select_bench import select_inputs, tie_aware_mismatch
    rows = {}
    for arch, (h, kv, d, _, _) in ARCH_SHAPES.items():
        g, scale = h // kv, 1.0 / math.sqrt(d)
        for per_head in (True, False):
            for kind in ("distinct", "tie", "invalid", "random"):
                q, summ, length = select_inputs("distinct" if kind == "invalid" else kind, B,
                                                kv, g, d, N_PAGES, N_SEL, torch.bfloat16, gen,
                                                dev)
                if kind == "invalid":          # pages 4..8 selectable, 56 lanes
                    length = torch.full((B,), N_SINK + N_WIN + 5 * P, dtype=torch.int32,
                                        device=dev)
                kw = dict(n_sel=N_SEL, scale=scale, page_size=P, n_sink=N_SINK,
                          n_window=N_WIN, per_head=per_head, keep_invalid=True)
                idx, pooled = ops.select_pages(q, summ, length, with_pooled=True, **kw)
                want, want_pooled = ref.select_pages_ref(
                    q, summ, length, N_SEL, scale, P, N_SINK, N_WIN, "mean_softmax", None,
                    per_head, True)
                torch.cuda.synchronize()
                what = f"select_pages {arch} {'per head' if per_head else 'MeanS'} {kind}"
                require(idx.shape == want.shape and bool((idx >= 0).all()),
                        f"{what}: shape {tuple(idx.shape)} or a -1 lane")
                if kind == "random":
                    bad = tie_aware_mismatch(idx, want, want_pooled)
                    require(bad is None, f"{what}: {bad}")
                else:
                    require(torch.equal(idx, want), f"{what}: page ids differ")
                if kind == "invalid":
                    require(torch.equal(idx[..., 5:7].cpu(), torch.tensor([0, 1], dtype=torch.int32)
                                        .expand(idx.shape[:-1] + (2,))),
                            f"{what}: invalid lanes are not the lowest unselected ids")
        args = [select_inputs("random", B, kv, g, d, N_PAGES, N_SEL, torch.bfloat16, gen, dev)
                for _ in range(copies_for(B * N_PAGES * kv * 2 * d * 2))]
        # the per-head mode (Quest), then the pooled MeanS mode at the arch's
        # G as FreeKV's decode step calls it (-1 for invalid lanes)
        for per_head, key in ((True, arch), (False, f"{arch} MeanS")):
            kw = dict(n_sel=N_SEL, scale=scale, page_size=P, n_sink=N_SINK, n_window=N_WIN,
                      per_head=per_head, keep_invalid=per_head)
            ms, call_ms = time_ms(lambda q, s, n: ops.select_pages(q, s, n, **kw), args)
            mode = "max_qk" if per_head else "mean_softmax"
            plain_ms, _ = time_ms(lambda q, s, n: ref.select_pages_ref(
                q, s, n, N_SEL, scale, P, N_SINK, N_WIN, mode, None, per_head, per_head),
                args, iters=10)
            rows[key] = {"shape": f"q({B},{kv},{g},{d}) summ({B},{N_PAGES},{kv},2,{d}) n_sel "
                                  f"{N_SEL} " + ("per query head" if per_head else "MeanS"),
                         **rl.kernel_bound(kcost.select_pages(B, kv, g, N_PAGES, d, N_SEL, 2,
                                                           per_head=per_head)),
                         "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
                         "library_ms": None, "max_abs_err": 0.0, "ids": "exact"}
    return rows


def check_fill_shapes(ops, ref, dev, gen):
    """fill_pages and complete_page at d_head 80 (stablelm-3b, 32 KV heads),
    256 (gemma2-2b, 4 KV heads), 128 at 16 and 8 KV heads (deepseek, scout,
    jamba, internvl2), 128 at 4 KV heads (llama31-8b's tp=2 shard) and 64 at 6
    KV heads (whisper), exact against their plain versions
    (fp, and int8; fp32 and bf16; complete_page to a device and a pinned
    pool with some rows completing); fill_pages at B=1, T=8192 and
    complete_page to the pinned pool with every row completing timed at
    bf16 beside their bounds."""
    rows = {}
    lengths = ([8224, 6150, 4128, 7170], [8224, 6176, 4128, 7200])
    for arch in ("stablelm-3b", "gemma2-2b", "deepseek-moe-16b", "llama4-scout-17b-a16e",
                 "jamba-1.5-large-398b", "whisper-tiny", "internvl2-26b", *TP_SHAPES):
        _, kv, d, _, _ = ARCH_SHAPES[arch]

        def outs(b, n, dt, bits, pinned=False):
            return _pool_outputs(b, n, dt, bits, 0, dev, pinned, kv, d)
        for dt in (torch.float32, torch.bfloat16):
            k = torch.randn(1, CONTEXT, kv, d, generator=gen, device=dev).to(dt)
            v = torch.randn(1, CONTEXT, kv, d, generator=gen, device=dev).to(dt)
            win_k = torch.randn(B, N_WIN, kv, d, generator=gen, device=dev).to(dt)
            win_v = torch.randn(B, N_WIN, kv, d, generator=gen, device=dev).to(dt)
            for bits in (0, 8):
                got = outs(1, CONTEXT // P, dt, bits)
                want = tuple(None if t is None else t.clone() for t in got)
                ops.fill_pages(k, v, *got)
                ref.fill_pages_ref(k, v, *want)
                for pinned in (False, True):
                    cp = outs(B, N_PAGES, dt, bits, pinned)
                    for ls in lengths:
                        length = torch.tensor(ls, dtype=torch.int32, device=dev)
                        cw = tuple(None if t is None else t.to(dev, copy=True) for t in cp)
                        ops.complete_page(win_k, win_v, length, *cp)
                        ref.complete_page_ref(win_k, win_v, length, *cw)
                        torch.cuda.synchronize()
                        require(all(x is None or torch.equal(x.to(dev), y)
                                    for x, y in zip(cp, cw)),
                                f"complete_page {arch} {dt} int{bits} "
                                f"{'pinned' if pinned else 'device'} {ls}: not exact")
                torch.cuda.synchronize()
                require(all(x is None or torch.equal(x, y) for x, y in zip(got, want)),
                        f"fill_pages {arch} {dt} int{bits}: not exact")
            del k, v
        dt, n = torch.bfloat16, CONTEXT // P
        f_bound = rl.kernel_bound(kcost.fill_pages(1, n, P, kv, d, 2, 2))
        fargs = [(torch.randn(1, CONTEXT, kv, d, generator=gen, device=dev).to(dt),
                  torch.randn(1, CONTEXT, kv, d, generator=gen, device=dev).to(dt))
                 + outs(1, n, dt, 0) for _ in range(copies_for(f_bound["bound_bytes"]))]
        f_ms, f_call = time_ms(ops.fill_pages, fargs)
        f_plain, _ = time_ms(ref.fill_pages_ref, fargs, iters=10)
        win = tuple(torch.randn(B, N_WIN, kv, d, generator=gen, device=dev).to(dt)
                    for _ in range(2))
        every = torch.tensor(lengths[1], dtype=torch.int32, device=dev)
        host = outs(B, N_PAGES, dt, 0, True)
        c_ms, c_call = time_ms(ops.complete_page, [win + (every,) + host])
        c_plain, _ = time_ms(ref.complete_page_ref, [win + (every,) + outs(B, N_PAGES, dt, 0)],
                             iters=10)
        rows[arch] = {
            "fill_pages": {"shape": f"k,v(1,{CONTEXT},{kv},{d}) -> block(1,{n},{kv},2,{P},{d}) "
                                    "bf16 + summ", **f_bound, "kernel_ms": f_ms,
                           "kernel_call_ms": f_call, "plain_ms": f_plain, "library_ms": None,
                           "max_abs_err": 0.0},
            "complete_page": {"shape": f"rings({B},{N_WIN},{kv},{d}) -> pinned pool, every row "
                                       "completing",
                              **rl.kernel_bound(kcost.complete_page(B, P, kv, d, 2)),
                              "kernel_ms": c_ms, "kernel_call_ms": c_call,
                              "plain_ms": c_plain, "library_ms": None, "max_abs_err": 0.0}}
    return rows


def check_recall_gather_shapes(ops, ref, dev, gen):
    """recall_gather at each tensor-parallel shard layout (``TP_SHAPES``:
    llama31-8b's tp=2 shard, 4 KV heads): exact against its plain version
    from a device and a pinned pool (fp32 and bf16, -1 lanes); timed at bf16
    from the pinned pool cycling disjoint selections (every lane valid)
    beside its bound, the link's ceiling, its plain version and advanced
    indexing on a device pool."""
    from repro_torch.launch import gather_bench
    rows = {}
    for arch, (_, kv, d, _, _) in TP_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
            pool = torch.randn(B, N_PAGES, kv, 2, P, d, generator=gen, device=dev).to(dt)
            idx = torch.randint(-1, N_PAGES, (B, kv, N_SEL), generator=gen, device=dev,
                                dtype=torch.int32)
            want = ref.recall_gather_ref(pool, idx)
            for src in (pool, pool.cpu().pin_memory()):
                got = ops.recall_gather(src, idx)
                torch.cuda.synchronize()
                require(all(torch.equal(a, b) for a, b in zip(got, want)),
                        f"recall_gather {arch} {dt} from {src.device}: not bit-exact")
        dt = torch.bfloat16
        pool = torch.randn(B, N_PAGES, kv, 2, P, d, generator=gen, device=dev).to(dt)
        host = pool.cpu().pin_memory()
        sels = [i[:, :kv].contiguous() for i in gather_bench.selections(gen, dev)]
        ms, call_ms = time_ms(ops.recall_gather, [(host, i) for i in sels])
        plain_ms, _ = time_ms(ref.recall_gather_ref, [(pool, sels[0])])
        bI = torch.arange(B, device=dev)[:, None, None]
        kI = torch.arange(kv, device=dev)[None, :, None]
        lib_ms, _ = time_ms(lambda p_, i_: p_[bI, i_.long(), kI], [(pool, sels[0])])
        cost = kcost.recall_gather(B, kv, N_SEL, P, d, 2, valid=int((sels[0] >= 0).sum()))
        rows[arch] = {"shape": f"pool({B},{N_PAGES},{kv},2,{P},{d}) pinned, idx({B},{kv},{N_SEL})",
                      **rl.kernel_bound(cost), "link_ms": gather_bench.link_ms(
                          cost["link_bytes"], dev),
                      "kernel_ms": ms, "kernel_call_ms": call_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "max_abs_err": 0.0}
        del pool, host
    return rows


# ---------------------------------------------------------------------------
# phase 3b: the MoE FFN and the Mamba mixer at full width. They are torch ops
# (the reference computes both in plain jnp, no Pallas kernel), so their
# numbers go on [moe] and [ssm] lines, not on the kernels line
# ---------------------------------------------------------------------------
def _seeded_normal(gen, dev):
    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).mul_(std)
    return normal


def _moe_bounds(cfg, n, kept, experts_used):
    """(the reference design's bound, the routed experts' own) for one MoE
    call of ``n`` bf16 tokens: bytes are the weights read once (the router
    float32) plus x in and y out; operations the three expert GEMMs (2 flops
    a multiply-add), the shared experts' and the router's. The reference
    design runs all E experts at capacity C; the routed bound counts only
    the experts this call's routing used and its ``kept`` assignments."""
    d, de, E = cfg.d_model, cfg.d_expert, cfg.n_experts
    ds = de * cfg.n_shared_experts
    c = 2 * 3 * d * de                       # one token through one expert
    fixed_b = d * E * 4 + 3 * d * ds * 2 + 2 * n * d * 2
    fixed_o = 2 * n * d * E + 2 * 3 * n * d * ds
    from repro_torch.models.moe import capacity
    cap = capacity(n, E, cfg.moe_top_k)
    design = rl.kernel_bound({"hbm_bytes": fixed_b + E * 3 * d * de * 2,
                              "flops": fixed_o + E * cap * c})
    routed = rl.kernel_bound({"hbm_bytes": fixed_b + experts_used * 3 * d * de * 2,
                              "flops": fixed_o + kept * c})
    return design, routed


def moe_layer_phase(dev):
    """One deepseek-moe-16b MoE layer at full width with seeded weights:
    the router biased toward experts 0-2 along a direction the inputs share
    (a logit ~9 higher), so that every token picks them and capacity binds
    at 8 and 1024 tokens. float32: apply_moe within
    1e-4 of the capacity-aware dense oracle at N = 4, 8, 1024 (drops
    required at 8 and 1024); bfloat16: N = 4 and 8192 bit-equal when run
    twice, a call at N = 4 under set_sync_debug_mode("error"), device ms at
    N = 4 and 8192 beside the two bounds of ``_moe_bounds``."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("deepseek-moe-16b")
    gen = torch.Generator(device=dev).manual_seed(23)
    p = moe.moe_init(cfg, _seeded_normal(gen, dev), torch.float32)
    m = torch.randn(cfg.d_model, generator=gen, device=dev)
    m = m / m.norm()
    p["router"][:, :3] += 3.0 * m[:, None]

    def inputs(n, dt):
        x = torch.randn(1, n, cfg.d_model, generator=gen, device=dev) + 3.0 * m
        return x.to(dt)

    def routing(x):
        xf = x.reshape(-1, cfg.d_model)
        _, idx, _ = moe.route(cfg, p["router"], xf)
        keep = moe.capacity_keep_mask(idx, cfg.n_experts,
                                      moe.capacity(xf.shape[0], cfg.n_experts, cfg.moe_top_k))
        return int(keep.sum()), int(torch.unique(idx[keep]).numel()), int((~keep).sum())

    out = {"layer": f"E {cfg.n_experts} x ({cfg.d_model} x {cfg.d_expert}) top-{cfg.moe_top_k}"
                    f" + {cfg.n_shared_experts} shared", "fp32": {}, "bf16": {}}
    for n in (4, 8, 1024):
        x = inputs(n, torch.float32)
        y = moe.apply_moe(cfg, p, x)[0]
        want = moe.moe_dense_reference(cfg, p, x)
        err = (y - want).abs().max().item()
        kept, used, dropped = routing(x)
        require(torch.allclose(y, want, atol=1e-4, rtol=1e-4),
                f"[moe] N={n}: apply_moe against the dense oracle, max |err| {err}")
        require(n == 4 or dropped > 0, f"[moe] N={n}: the biased router dropped nothing")
        out["fp32"][n] = {"max_abs_err_vs_oracle": err, "dropped": dropped,
                          "capacity": moe.capacity(n, cfg.n_experts, cfg.moe_top_k)}
        del x, y, want
    pb = {k: (v if k == "router" else _tree_map(lambda t: t.to(torch.bfloat16), v))
          for k, v in p.items()}
    del p
    p = pb
    for n in (4, 8192):
        x = inputs(n, torch.bfloat16)
        y1, y2 = moe.apply_moe(cfg, p, x)[0], moe.apply_moe(cfg, p, x)[0]
        require(torch.equal(y1, y2), f"[moe] bf16 N={n}: two runs differ")
        require(bool(torch.isfinite(y1).all()), f"[moe] bf16 N={n}: non-finite output")
        if n == 4:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                moe.apply_moe(cfg, p, x)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        kept, used, dropped = routing(x)
        ms, call_ms = time_ms(lambda x: moe.apply_moe(cfg, p, x), [(x,)],
                              iters=20 if n == 4 else 3)
        design, routed = _moe_bounds(cfg, n, kept, used)
        out["bf16"][n] = {"ms": ms, "call_ms": call_ms, "bound_reference_design": design,
                          "bound_routed": routed, "experts_used": used, "kept": kept,
                          "dropped": dropped, "bit_equal_repeat": True,
                          "sync_free": n == 4}
        del x, y1, y2
    del p
    torch.cuda.empty_cache()
    return out


def ssm_layer_phase(dev):
    """One jamba-1.5-large-398b Mamba layer at full width with seeded
    weights: float32, 256 decode steps chained from the empty state (B=2)
    against mamba_forward's outputs and final state within 1e-4 (the
    largest error logged); bfloat16, a decode step at B=4 under
    set_sync_debug_mode("error"), device ms of a decode step at B=4 and of
    a prefill at T=2048 (B=1) beside their bounds (weights read once, the
    state h read and written, activations in and out; the prefill's
    projections at the bf16 peak)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    cfg = get_config("jamba-1.5-large-398b")
    di, r, ds, dk = ssm.mamba_dims(cfg)
    d = cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(29)
    p = ssm.mamba_init(cfg, _seeded_normal(gen, dev), torch.float32)
    T = 256
    x = 0.5 * torch.randn(2, T, d, generator=gen, device=dev)
    y, st = ssm.mamba_forward(cfg, p, x, return_state=True)
    s = ssm.mamba_init_state(cfg, 2, torch.float32, dev)
    ys = [ssm.mamba_decode_step(cfg, p, x[:, t:t + 1], s)[0] for t in range(T)]
    errs = {"y": (torch.cat(ys, dim=1) - y).abs().max().item(),
            "h": (s["h"] - st["h"]).abs().max().item(),
            "conv": (s["conv"] - st["conv"]).abs().max().item()}
    require(torch.allclose(torch.cat(ys, dim=1), y, atol=1e-4, rtol=1e-4)
            and torch.allclose(s["h"], st["h"], atol=1e-4, rtol=1e-4)
            and torch.allclose(s["conv"], st["conv"], atol=1e-4, rtol=1e-4),
            f"[ssm] chained decode against mamba_forward: max |err| {errs}")
    del x, y, st, s, ys
    p = {k: (v if k in ("A_log", "D") else v.to(torch.bfloat16)) for k, v in p.items()}
    Bd = 4
    xs = torch.randn(Bd, 1, d, generator=gen, device=dev).to(torch.bfloat16)
    s = ssm.mamba_init_state(cfg, Bd, torch.bfloat16, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ssm.mamba_decode_step(cfg, p, xs, s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(s["h"].dtype == torch.float32, "[ssm] h left float32")
    w_bytes = sum(t.numel() * t.element_size() for t in p.values())
    flops_tok = 2 * (d * 2 * di + di * (r + 2 * ds) + r * di + di * d)
    dec_ms, dec_call = time_ms(lambda x: ssm.mamba_decode_step(cfg, p, x, s), [(xs,)], iters=20)
    dec_bound = rl.kernel_bound({"hbm_bytes": w_bytes + 2 * s["h"].numel() * 4
                                 + 2 * s["conv"].numel() * 2 + 2 * Bd * d * 2,
                                 "flops": Bd * flops_tok})
    Tp = 2048
    xp = torch.randn(1, Tp, d, generator=gen, device=dev).to(torch.bfloat16)
    pre_ms, pre_call = time_ms(lambda x: ssm.mamba_forward(cfg, p, x), [(xp,)], iters=1)
    pre_bound = rl.kernel_bound({"hbm_bytes": w_bytes + 2 * Tp * d * 2, "flops": Tp * flops_tok})
    del p, xs, xp, s
    torch.cuda.empty_cache()
    return {"layer": f"d {d} d_inner {di} d_state {ds} d_conv {dk} dt_rank {r}",
            "chain_steps": T, "max_abs_err_chain_vs_forward": errs, "tolerance": 1e-4,
            "decode_b4": {"ms": dec_ms, "call_ms": dec_call, **dec_bound, "sync_free": True},
            "prefill_t2048": {"ms": pre_ms, "call_ms": pre_call, **pre_bound}}


def xlstm_layer_phase(dev):
    """One mLSTM and one sLSTM layer of xlstm-350m at full width (d 1024, 4
    heads, d_inner 2048, dqk 256 and dv 512 a head) with seeded weights:
    float32, 256 decode steps chained from the empty state (B=2) against
    the forward's outputs and final state within 1e-4 (the largest error
    logged; 256 steps are a whole sLSTM scan chunk); bfloat16 weights (the
    gates' float32), a decode step at B=4 under set_sync_debug_mode("error"),
    device ms of a decode step at B=4 and of a prefill at T=2048 (B=1)
    beside their bounds: the weights read once, the state read and written,
    activations in and out; the bf16 projections at the bf16 peak and the
    float32 gates, recurrence and mLSTM chunk products at float32's."""
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm
    cfg = get_config("xlstm-350m")
    d = cfg.d_model
    di, nh, dv, dqk = xlstm.xlstm_dims(cfg)
    dh, chunk, T, Bd, Tp = di // nh, 256, 256, 4, 2048
    gen = torch.Generator(device=dev).manual_seed(31)
    f32_keys = {"mlstm": ("wi", "wf", "bf"), "slstm": ("W", "R", "b")}
    # bf16 products a token (up, down and, for the mLSTM, q k v) and float32
    # ones (the gates, the sLSTM's W and recurrence); then the mixers' own
    proj = 2 * (d * 2 * di + di * d)
    tok_ops = {"mlstm": (proj + 2 * di * nh * (2 * dqk + dv), 2 * di * 2 * nh),
               "slstm": (proj, 2 * di * 4 * di + 2 * nh * 4 * dh * dh)}
    # the mLSTM state's update and read a decode token, and a prefill
    # token's chunk products (intra-chunk q k and weights v, the carried
    # state's read and update)
    mix_dec = {"mlstm": 5 * nh * dqk * dv, "slstm": 0}
    mix_pre = {"mlstm": 2 * chunk * nh * (dqk + dv) + 4 * nh * dqk * dv, "slstm": 0}
    out = {"layer": f"d {d} heads {nh} d_inner {di} dqk {dqk} dv {dv} a head",
           "chain_steps": T, "tolerance": 1e-4}
    for kind in ("mlstm", "slstm"):
        fwd = getattr(xlstm, kind + "_forward")
        step = getattr(xlstm, kind + "_decode_step")
        init = getattr(xlstm, kind + "_init_state")
        p = getattr(xlstm, kind + "_init")(cfg, _seeded_normal(gen, dev), torch.float32)
        x = 0.5 * torch.randn(2, T, d, generator=gen, device=dev)
        y, st = fwd(cfg, p, x, return_state=True)
        s = init(cfg, 2, dev)
        ys = torch.cat([step(cfg, p, x[:, t:t + 1], s)[0] for t in range(T)], dim=1)
        errs = {"y": (ys - y).abs().max().item(),
                **{k: (s[k] - st[k]).abs().max().item() for k in st}}
        require(torch.allclose(ys, y, atol=1e-4, rtol=1e-4)
                and all(torch.allclose(s[k], st[k], atol=1e-4, rtol=1e-4) for k in st),
                f"[xlstm] {kind}: chained decode against the forward, max |err| {errs}")
        del x, y, st, s, ys
        p = {k: (v if k in f32_keys[kind] else v.to(torch.bfloat16)) for k, v in p.items()}
        xs = torch.randn(Bd, 1, d, generator=gen, device=dev).to(torch.bfloat16)
        s = init(cfg, Bd, dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(cfg, p, xs, s)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require(all(t.dtype == torch.float32 for t in s.values()), f"[xlstm] {kind}: a state "
                "leaf left float32")
        w_bytes = sum(t.numel() * t.element_size() for t in p.values())
        s_bytes = sum(t.numel() * t.element_size() for t in s.values())
        ob, of = tok_ops[kind]
        dec_ms, dec_call = time_ms(lambda x: step(cfg, p, x, s), [(xs,)], iters=20)
        # the products run partly in bf16 (tensor cores), partly in float32
        dec_bound = rl.kernel_bound({"hbm_bytes": w_bytes + 2 * s_bytes + 2 * Bd * d * 2,
                                     "flops": Bd * ob, "flops_f32": Bd * (of + mix_dec[kind])})
        xp = torch.randn(1, Tp, d, generator=gen, device=dev).to(torch.bfloat16)
        pre_ms, pre_call = time_ms(lambda x: fwd(cfg, p, x), [(xp,)], iters=1)
        pre_bound = rl.kernel_bound({"hbm_bytes": w_bytes + 2 * Tp * d * 2, "flops": Tp * ob,
                                     "flops_f32": Tp * (of + mix_pre[kind])})
        out[kind] = {"max_abs_err_chain_vs_forward": errs,
                     "decode_b4": {"ms": dec_ms, "call_ms": dec_call, **dec_bound,
                                   "sync_free": True, "state_bytes_a_row": s_bytes // Bd},
                     "prefill_t2048": {"ms": pre_ms, "call_ms": pre_call, **pre_bound}}
        del p, xs, xp, s
        torch.cuda.empty_cache()
    return out


# phase 3b, the recurrent mixers' model-parallel forms (models/ssm, models/xlstm,
# models/model._recurrent_forward), every shard on the card: each held
# against its whole form on the same float32 inputs, a prefill of
# MIXER_MESH_T tokens and MIXER_MESH_STEPS decode steps from its state
MIXER_MESH_T, MIXER_MESH_STEPS, MIXER_MESH_B = 64, 8, 2
# (arch, layer index, mesh): jamba's Mamba at (1, 4), xlstm-350m's mLSTM
# (layer 0) and sLSTM (layer 5) at (1, 2)
MIXER_MESH = (("jamba-1.5-large-398b", 0, (1, 4)), ("xlstm-350m", 0, (1, 2)),
              ("xlstm-350m", 5, (1, 2)))


def _placed_mixer(cfg, i, p, mesh):
    """Layer i's mixer params placed on data group 0 as serving places them
    (``rules.serving_spec``)."""
    from repro_torch.sharding import rules
    out = {}
    for k, t in p.items():
        spec = rules.serving_spec(cfg, mesh, f"layers/{i}/mixer/{k}", t.shape)
        out[k] = (rules.Halves(t, mesh, 0) if spec == "halves"
                  else rules.Sharded.place(t, spec, mesh, 0))
    return out


def mixer_mesh_phase(dev):
    """Each ``MIXER_MESH`` layer at full width with seeded float32 weights,
    B = MIXER_MESH_B: the mesh form (Mamba split by d_inner, the mLSTM by
    head, the sLSTM whole on shard 0) over a mesh of shards on ``dev``
    against the whole form on the same inputs: the prefill's output and
    state, then each decode step's output and the final state, within
    TOL[float32] (each state block joined back); the mesh form fetches no
    weight (the serving placement). Device ms of a mesh and of a whole
    decode step, and the bytes a mesh step moves between shards."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import ssm, xlstm
    from repro_torch.sharding.transfer import MeshRow
    out = {}
    for arch, i, dims in MIXER_MESH:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        mixer = cfg.layers[i][0]
        gen = torch.Generator(device=dev).manual_seed(37 + i)
        init = {"mamba": ssm.mamba_init, "mlstm": xlstm.mlstm_init,
                "slstm": xlstm.slstm_init}[mixer]
        p = init(cfg, _seeded_normal(gen, dev), torch.float32)
        mesh = _mesh(dims, dev)
        row = MeshRow(mesh, 0)
        placed = _placed_mixer(cfg, i, p, mesh)
        T, S, Bm = MIXER_MESH_T, MIXER_MESH_STEPS, MIXER_MESH_B
        x = 0.5 * torch.randn(Bm, T + S, cfg.d_model, generator=gen, device=dev)
        y, st = M._FORWARD[mixer](cfg, p, x[:, :T], return_state=True)
        mesh.moved.reset()
        ym, sts = M._recurrent_forward(cfg, mixer, placed, x[:, :T], row, return_state=True)
        split = M._STATE_SPLIT.get(mixer, {})

        def joined(blocks):
            if len(blocks) == 1:
                return blocks[0]
            return {k: torch.cat([b[k].to(dev) for b in blocks], dim=split[k])
                    for k in blocks[0]}
        errs = {"prefill_y": (ym - y).abs().max().item()}
        ok = torch.allclose(ym, y, **TOL[torch.float32])
        for k, v in joined(sts).items():
            errs["prefill_" + k] = (v - st[k]).abs().max().item()
            ok = ok and torch.allclose(v, st[k], **TOL[torch.float32])
        worst = 0.0
        for t in range(S):
            xt = x[:, T + t:T + t + 1]
            yw = M._DECODE_STEP[mixer](cfg, p, xt, st)[0]
            yt = M._recurrent_step(cfg, mixer, placed, xt, sts, row)
            worst = max(worst, (yt - yw).abs().max().item())
            ok = ok and torch.allclose(yt, yw, **TOL[torch.float32])
        errs["decode_y"] = worst
        for k, v in joined(sts).items():
            errs["final_" + k] = (v - st[k]).abs().max().item()
            ok = ok and torch.allclose(v, st[k], **TOL[torch.float32])
        run = f"[mixer-mesh] {arch} layer {i} {mixer} {dims[0]}x{dims[1]}"
        require(ok, f"{run}: the mesh form against the whole form, max |err| {errs}, "
                f"tolerance {TOL[torch.float32]}")
        require(mesh.moved.bytes["weight_gather"] == 0, f"{run}: fetched weights "
                f"{mesh.moved.bytes['weight_gather']} B")
        xs = x[:, T:T + 1]
        mesh.moved.reset()
        M._recurrent_step(cfg, mixer, placed, xs, sts, row)
        moved = {k: v for k, v in mesh.moved.bytes.items() if v}
        mesh_ms, mesh_call = time_ms(lambda x: M._recurrent_step(cfg, mixer, placed, x, sts,
                                                                  row), [(xs,)], iters=10)
        whole_ms, whole_call = time_ms(lambda x: M._DECODE_STEP[mixer](cfg, p, x, st), [(xs,)],
                                       iters=10)
        out[f"{arch} {mixer} {dims[0]}x{dims[1]}"] = {
            "shards_holding_state": len(sts), "batch": Bm, "prefill_tokens": T,
            "decode_steps": S, "max_abs_err": errs, "tol": TOL[torch.float32],
            "mesh_step_ms": mesh_ms, "mesh_step_call_ms": mesh_call, "whole_step_ms": whole_ms,
            "whole_step_call_ms": whole_call, "moved_bytes_per_step": moved,
            "s": time.perf_counter() - t0}
        del p, placed, x, y, st, ym, sts
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4 and 5
# ---------------------------------------------------------------------------
def llama_params(dev):
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config("llama31-8b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[main] llama31-8b params on the card: "
        f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


def half_depth(cfg, params=None):
    """``cfg`` at full width with half its periods (its prelude kept), and
    ``params``' layers cut to match (the same tensors). Phase 4's runs
    other than freekv/none, phase 4b, 4c and 4d run at this depth: they are
    host-bound, their time linear in the layers, and the script must stay
    inside its time limit with phase 6 added."""
    n_periods = max(1, cfg.n_periods // 2)
    cut = dataclasses.replace(cfg, n_periods=n_periods,
                              n_layers=len(cfg.prelude) + len(cfg.pattern) * n_periods)
    if params is None:
        return cut
    return cut, {**params, "layers": params["layers"][:cut.n_layers]}


# the kernels each main-path run must launch (recall_gather reads the fp
# pool, recall_gather_quant the quantized one; ShadowKV's decode recalls V
# halves only; Centroid scores its cluster boxes every step)
_COMMON = ("paged_attention", "select_pages", "fill_pages", "complete_page", "flash_prefill")
RUNS = {
    ("freekv", "none"): _COMMON + ("recall_gather",),
    ("freekv", "int8"): _COMMON + ("recall_gather_quant",),
    ("shadowkv", "none"): _COMMON + ("recall_values",),
    ("shadowkv", "int8"): _COMMON + ("recall_values_quant",),
    ("centroid", "none"): _COMMON + ("centroid_candidates", "recall_gather"),
}
# the scores-only and summary-only entries: held in phase 3, never on the
# main path
OFF_PATH = ("page_scores", "centroid_scores", "page_summary")


def main_requests(cfg, fkv):
    """Phase 4's eight needle requests (CONT_PROMPTS, CONT_NEW)."""
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.serving.engine import Request
    return [Request(uid=i, tokens=next(needle_stream(cfg.vocab_size, n, fkv.page_size,
                                                     seed=i)).tokens, max_new_tokens=m)
            for i, (n, m) in enumerate(zip(CONT_PROMPTS, CONT_NEW))]


# the profiled window's steps: 4, not the engine's sync_interval of 8, since a
# profiled step costs the host many times an unprofiled one (the time limit)
MAIN_WINDOW = 4


def main_path(dev, ops, cfg, params, method, kv_quant, scheduler="continuous"):
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.obs import Observability
    from repro_torch.quant.accounting import page_block_bytes
    from repro_torch.serving.engine import ServeEngine

    fkv = FreeKVConfig(method=method, offload="host", kv_quant=kv_quant)
    reqs = main_requests(cfg, fkv)
    # one prefill per admitted request, or per lockstep batch of B
    prefills = len(reqs) if scheduler == "continuous" else -(-len(reqs) // B)
    # the per-step latency histogram (no trace): decode ms a step
    eng = ServeEngine(cfg, fkv, params, max_len=MAX_LEN, batch_size=B,
                      state_dtype=torch.bfloat16, scheduler=scheduler,
                      obs=Observability(enabled=True), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    em = eng.last_metrics
    run = f"{scheduler} {method}/{kv_quant}"
    require(eng.last_logits_finite, f"non-finite logits on the main path ({run})")
    for o, r in zip(outs, reqs):
        require(len(o.tokens) == r.max_new_tokens, f"request {o.uid}: {len(o.tokens)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in o.tokens), f"request {o.uid}: bad token")
    for name in RUNS[(method, kv_quant)]:
        require(launches[name] > 0, f"{name} was never launched on the main path ({run})")
    for name in OFF_PATH:
        require(launches[name] == 0, f"{name} launched on the main path ({run})")
    # one flash_prefill and one fill_pages a layer for each prefill (each
    # admitted request under the continuous scheduler, the batch under the
    # static one); one complete_page a layer for each decode step, whatever
    # the lengths
    steps = em.steps
    for name, per_layer in (("flash_prefill", prefills), ("fill_pages", prefills),
                            ("complete_page", steps)):
        require(launches[name] == cfg.n_layers * per_layer,
                f"{name} launched {launches[name]} times for {per_layer} "
                f"{'decode steps' if name == 'complete_page' else 'prefills'} of "
                f"{cfg.n_layers} layers ({run})")
    if scheduler == "continuous":
        # a page completed during decode: every layer's pool holds the page
        # past the longest prompt's whole pages, which no prefill writes (a
        # freed slot's summaries are reset, its pool pages kept)
        torch.cuda.synchronize(dev)
        page = max(CONT_PROMPTS) // P
        for i, layer in enumerate(eng._pool.state["layers"]):
            require(bool(layer["pool"][:, page].ne(0).any()),
                    f"no page completed during decode ({run}): layer {i}'s pool page {page} "
                    "is empty in every slot")
    lat = em.summary()["latency"]["decode_step_s"]
    decode_ms = 1e3 * lat["sum"] / lat["count"]
    # measured by either engine: from generate()'s start to the first
    # token's arrival on the host
    ttft = [o.metrics.ttft_s for o in outs]
    gen_tokens = sum(len(o.tokens) for o in outs)
    info = {"arch": cfg.name, "layers": cfg.n_layers, "scheduler": scheduler, "method": method,
            "kv_quant": kv_quant,
            "slots": B, "requests": len(reqs), "prompt_tokens": [len(r.tokens) for r in reqs],
            "tokens_per_request": [len(o.tokens) for o in outs],
            "ttft_s": ttft, "prefill_s": [o.prefill_s for o in outs],
            "decode_ms_per_step": decode_ms, "decode_steps": steps,
            "slot_occupancy": em.slot_occupancy,
            "host_syncs": em.host_syncs, "host_syncs_per_token": em.host_syncs / gen_tokens,
            "host_syncs_per_step": em.host_syncs / max(steps, 1),
            "tokens_per_s": gen_tokens / wall, "wall_s": wall,
            "bytes_per_recalled_page": page_block_bytes(fkv, cfg.d_head, itemsize=2),
            "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "correction_rate": outs[0].stats.get("correction_rate"),
            "spec_hit_rate": outs[0].stats.get("spec_hit_rate"),
            "dropped_in_flight_pages": em.dropped_pages,
            "recall_overlap": {k: em.summary()["recall_overlap"][k]
                               for k in ("exposed_bytes", "hidden_bytes",
                                         "dropped_in_flight_bytes")},
            "launches": launches,
            "launches_per_decode_step": {k: v / max(steps, 1) for k, v in launches.items()},
            "first_tokens": outs[0].tokens[:8], "tokens": {o.uid: o.tokens for o in outs}}
    # valid lanes of the critical-path top-up and of the staged gather, each
    # over every lane of the live rows' launches (kv x n_sel a row)
    lanes = em.active_slot_steps * cfg.n_layers * KV * N_SEL
    info["topup_valid_share"] = sum(o.stats.get("sync_pages", 0) for o in outs) / lanes
    info["staged_valid_share"] = sum(o.stats.get("async_pages", 0) for o in outs) / lanes
    del eng, outs
    torch.cuda.empty_cache()
    if scheduler == "continuous":
        # host ops, device operations and busy share of a few eager decode
        # steps, and for freekv/none of a continuous window of MAIN_WINDOW steps
        from repro_torch.launch.decode_profile import profile_decode
        stream = needle_stream(cfg.vocab_size, CONTEXT, fkv.page_size, seed=0)
        toks = torch.from_numpy(np.stack([next(stream).tokens for _ in range(B)]))
        main = (method, kv_quant) == ("freekv", "none")
        window = MAIN_WINDOW if main else 0
        # a profiled step costs the host many times an unprofiled one (the
        # script's time limit): one eager step each
        prof = profile_decode(cfg, fkv, params, toks.long().to(dev), steps=1,
                              with_prefill=False, window=window, completion=main)
        info["profile"] = {k: prof[k] for k in ("wall_ms_per_step_unprofiled",
                                                "cpu_ops_per_step", "device_ops_per_step",
                                                "device_busy_ms_per_step", "device_busy_share",
                                                "spans")}
        if main:
            info["profile"]["completion"] = prof["completion"]
        if window:
            info["profile"]["window"] = prof["window"]
            # the window's one read at its end is its only wait for the card
            require(prof["window"]["host_syncs_per_step"] <= 1 / window,
                    f"a decode window of {window} steps made the host wait for the card "
                    f"{prof['window']['sync_calls']} times, starting at "
                    f"{prof['window']['sync_starts_us']} us of {prof['window']['range_us']} "
                    f"({run})")
        torch.cuda.empty_cache()
    return info, launches


# ---------------------------------------------------------------------------
# phase 4's [cost] line: the cost model against the card on the main path
# ---------------------------------------------------------------------------
# the launches of one llama31-8b decode step (32 layers): FreeKV's top-up
# and staged recall are two gathers a layer
COST_STEP_LAUNCHES = {"paged_attention": 32, "select_pages": 32, "complete_page": 32,
                      "recall_gather": 64}


def _per_op_diff(a, b):
    return {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b))
            if (a.get(k) or {}).get("bytes") != (b.get(k) or {}).get("bytes")
            or (a.get(k) or {}).get("flops") != (b.get(k) or {}).get("flops")}


def cost_phase(dev, ops, cfg, params, measured_ms):
    """One llama31-8b ``serve_step`` at phase 4's engine shape (B 4, the
    FreeKVConfig defaults, the pool in pinned host memory, prompts of 8192
    tokens; the second step after the prefill) counted by
    ``launch/op_cost`` on the card and the same step on
    the meta device: FLOPs, bytes, link bytes and every kernel's launches
    and bytes must be equal, and the launches must equal the ``.launches``
    deltas of the card's step. Then the cost model's analytic bound for the
    step (``roofline.decode_byte_parts``: all over HBM, and with the pool
    part over PCIe) beside phase 4's measured continuous freekv/none
    ms/step."""
    from repro_torch.configs.base import FreeKVConfig, ShapeConfig
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.launch import op_cost
    from repro_torch.models.model import init_decode_state, init_params, prefill, serve_step
    t0 = time.perf_counter()
    fkv = FreeKVConfig(offload="host")
    stream = needle_stream(cfg.vocab_size, CONTEXT, fkv.page_size, seed=0)
    toks = torch.from_numpy(np.stack([next(stream).tokens for _ in range(B)])).long().to(dev)
    _, state = prefill(cfg, fkv, params, {"tokens": toks}, max_len=MAX_LEN)
    # one step first: a kernel's one-time workspaces (paged_attention's
    # ticket counters on a stream) are no part of a step
    serve_step(cfg, fkv, params, state, toks[:, -1:])
    torch.cuda.synchronize(dev)
    ops.reset_launches()
    card = op_cost.analyze(serve_step, cfg, fkv, params, state, toks[:, -1:])
    torch.cuda.synchronize(dev)
    deltas = {fn.__name__: fn.launches for fn in ops.KERNELS if fn.launches}
    require(bool(torch.isfinite(card["out"][0].float()).all()), "[cost] non-finite logits")
    del state, card["out"]
    meta_params = init_params(cfg, device="meta", dtype=torch.bfloat16)
    meta_state = init_decode_state(cfg, fkv, B, MAX_LEN, torch.bfloat16, "meta")
    meta = op_cost.analyze(serve_step, cfg, fkv, meta_params, meta_state,
                           torch.zeros((B, 1), dtype=torch.long, device="meta"))
    for key in ("flops", "bytes", "link_bytes", "aten_flops", "aten_bytes"):
        require(card[key] == meta[key],
                f"[cost] {key}: {card[key]} counted on the card, {meta[key]} on meta; ops that "
                f"differ {json.dumps(_per_op_diff(card['per_op'], meta['per_op']))}")
    require(card["kernels"] == meta["kernels"],
            f"[cost] kernels: card {card['kernels']} meta {meta['kernels']}")
    counted = {k: v["launches"] for k, v in card["kernels"].items()}
    require(counted == deltas == COST_STEP_LAUNCHES,
            f"[cost] launches counted {counted}, .launches deltas {deltas}, expected "
            f"{COST_STEP_LAUNCHES}")
    shape = ShapeConfig("phase4_decode", CONTEXT, B, "decode")
    parts = rl.decode_byte_parts(cfg, fkv, shape)
    hbm_ms = 1e3 * rl.decode_step_bound_s(parts)
    link_ms = 1e3 * rl.decode_step_bound_s(parts, pool_link=True)
    terms = rl.roofline_terms(card["flops"], card["bytes"], 0.0)
    return {"arch": cfg.name, "slots": B, "context": CONTEXT, "fkv": "FreeKVConfig(offload='host')",
            "flops": card["flops"], "bytes": card["bytes"], "aten_bytes": card["aten_bytes"],
            "link_bytes": card["link_bytes"], "launches": counted,
            "kernels": card["kernels"], "card_equals_meta": True,
            "top_ops_bytes": op_cost.top_ops(card, "bytes", 5),
            "analytic_parts_bytes": parts, "analytic_bound_ms": hbm_ms,
            "analytic_bound_pool_pcie_ms": link_ms,
            "counted_bound_ms": 1e3 * terms.bound_s, "counted_dominant": terms.dominant,
            "measured_ms_per_step": measured_ms, "share": hbm_ms / measured_ms,
            "share_pool_pcie": link_ms / measured_ms, "phase_s": time.perf_counter() - t0}


# phase 4b: the scheduler's features at full width, each pair the same
# traffic with the feature off and then on
CHUNK_BUDGET = 1024


def _feature_run(dev, ops, cfg, params, reqs, slots, max_len, label, chunk=0, preempt=False,
                 prefix_cache_tokens=0, prefill_bucket=1):
    """One run of freekv/none (bf16, pinned host pool) with the given
    scheduler features; returns the engine, its completions and the
    kernels' launch counts of the run."""
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.serving.engine import ServeEngine

    fkv = FreeKVConfig(method="freekv", offload="host", prefill_chunk_tokens=chunk,
                       preempt=preempt)
    eng = ServeEngine(cfg, fkv, params, max_len=max_len, batch_size=slots,
                      state_dtype=torch.bfloat16, prefill_bucket=prefill_bucket,
                      prefix_cache_tokens=prefix_cache_tokens, device=dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    require(eng.last_logits_finite, f"non-finite logits ({label})")
    for o, r in zip(outs, reqs):
        require(len(o.tokens) == r.max_new_tokens and all(0 <= t < cfg.vocab_size
                                                          for t in o.tokens),
                f"request {o.uid}: {len(o.tokens)} tokens or one out of range ({label})")
    em = eng.last_metrics
    prefills = len(reqs)                     # one each; a resume prefills nothing
    per_prefill = em.prefill_chunks if chunk else prefills
    for name, n in (("flash_prefill", per_prefill), ("fill_pages", prefills),
                    ("complete_page", em.steps)):
        require(launches[name] == cfg.n_layers * n,
                f"{name} launched {launches[name]} times, not {cfg.n_layers} x {n} ({label})")
    for name in ("paged_attention", "select_pages", "recall_gather"):
        require(launches[name] > 0, f"{name} never launched ({label})")
    for name in OFF_PATH:
        require(launches[name] == 0, f"{name} launched ({label})")
    return eng, outs, launches, wall


def _agreement(a, b):
    """Per request: tokens equal position by position, and the length of
    the common prefix."""
    out = []
    for x, y in zip(a, b):
        lead = next((i for i, (s, t) in enumerate(zip(x, y)) if s != t), min(len(x), len(y)))
        out.append({"equal": sum(s == t for s, t in zip(x, y)), "of": len(x),
                    "common_prefix": lead})
    return out


def feature_pairs(dev, ops, cfg, params):
    """Phase 4b: llama31-8b at full width, bf16, freekv/none, pinned host
    pool; three pairs, each the same traffic with the feature off, then on:
    (a) chunked prefill, (b) the prefix cache, (c) priority preemption."""
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.serving.engine import Request
    from repro_torch.serving.scheduler import _swap_bytes

    def needle(n, seed):
        return next(needle_stream(cfg.vocab_size, n, P, seed=seed)).tokens

    res = {"layers": cfg.n_layers}
    # (a) four 2048-token needle prompts fill the 4 slots; request 0 stops
    # after 8 tokens, and the 8192-token request 4 takes its slot while
    # the other three decode
    reqs = [Request(uid=i, tokens=needle(n, 50 + i), max_new_tokens=m)
            for i, (n, m) in enumerate(zip((2048,) * 4 + (CONTEXT,), (8, 40, 40, 40, 16)))]
    runs = {}
    for name, chunk in (("off", 0), ("on", CHUNK_BUDGET)):
        eng, outs, launches, wall = _feature_run(dev, ops, cfg, params, reqs, B, MAX_LEN,
                                                 f"chunked prefill {name}", chunk=chunk)
        em = eng.last_metrics
        runs[name] = {"tokens": [o.tokens for o in outs],
                      "max_token_gap_s": [o.metrics.max_token_gap_s for o in outs],
                      "ttft_s": [o.metrics.ttft_s for o in outs],
                      "prefill_chunks": em.prefill_chunks,
                      "prefill_chunk_tokens": em.prefill_chunk_tokens, "steps": em.steps,
                      "launches": {k: launches[k] for k in ("flash_prefill", "fill_pages",
                                                            "complete_page")},
                      "wall_s": wall}
        del eng, outs
        torch.cuda.empty_cache()
    require(runs["on"]["prefill_chunks"] == 4 * 2 + CONTEXT // CHUNK_BUDGET,
            f"chunked prefill ran {runs['on']['prefill_chunks']} chunks")
    res["chunked"] = {"budget": CHUNK_BUDGET, **runs,
                      "agreement": _agreement(runs["off"]["tokens"], runs["on"]["tokens"])}

    # (b) four prompts sharing a 6144-token prefix, each with its own 1024
    # tokens, over 2 slots; a bucket of one page keeps the reused span
    # page-aligned
    shared = needle(6144, 60)
    reqs = [Request(uid=i, tokens=np.concatenate([shared, needle(1024, 61 + i)]),
                    max_new_tokens=16) for i in range(4)]
    runs = {}
    for name, cache in (("off", 0), ("on", 16384)):
        eng, outs, launches, wall = _feature_run(dev, ops, cfg, params, reqs, 2, 7168 + 64,
                                                 f"prefix cache {name}",
                                                 prefix_cache_tokens=cache, prefill_bucket=P)
        runs[name] = {"tokens": [o.tokens for o in outs],
                      "ttft_s": [o.metrics.ttft_s for o in outs],
                      "prefill_s": [o.prefill_s for o in outs],
                      "prefix_hit_tokens": [o.metrics.prefix_hit_tokens for o in outs],
                      "prefix_cache": eng.last_metrics.prefix_cache, "wall_s": wall}
        if cache:
            # a hit and an insert again, each timed to its end: request 1's
            # prompt, cached whole by now but for its last bucket, from
            # pinned host into fresh buffers, then those buffers' whole
            # prompt into the trie under a new first token (card to pinned
            # host, the allocation included)
            seq = tuple(int(t) for t in eng._padded_prompt(reqs[1]))
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            tp, parts = eng._cache_lookup(seq)
            kv = eng._load_prefix(parts, len(seq))
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            added = eng._cache_insert(((seq[0] + 1) % cfg.vocab_size,) + seq[1:], kv)
            torch.cuda.synchronize(dev)
            per_token = sum(t.numel() * t.element_size() for pair in kv for t in pair) // len(seq)
            runs[name]["copies_timed"] = {
                "hit": {"tokens": tp, "bytes": tp * per_token, "ms": 1e3 * (t1 - t0)},
                "insert": {"tokens": added, "bytes": added * per_token,
                           "ms": 1e3 * (time.perf_counter() - t1)}}
            del kv, parts
        del eng, outs
        torch.cuda.empty_cache()
    require(runs["on"]["prefix_hit_tokens"] == [0, 6144, 6144, 6144],
            f"prefix hits {runs['on']['prefix_hit_tokens']}, not [0, 6144, 6144, 6144]")
    res["prefix_cache"] = {**runs,
                           "agreement": _agreement(runs["off"]["tokens"], runs["on"]["tokens"])}

    # (c) four priority-0 requests fill the 4 slots; a fifth of priority 1
    reqs = [Request(uid=i, tokens=needle(4096, 70 + i), max_new_tokens=48 if i < 4 else 16,
                    priority=int(i == 4)) for i in range(5)]
    runs = {}
    for name, preempt in (("off", False), ("on", True)):
        eng, outs, launches, wall = _feature_run(dev, ops, cfg, params, reqs, B, 4096 + 64,
                                                 f"preemption {name}", preempt=preempt)
        em = eng.last_metrics
        runs[name] = {"tokens": [o.tokens for o in outs],
                      "ttft_s": [o.metrics.ttft_s for o in outs],
                      "preemptions": [o.metrics.preemptions for o in outs],
                      "swap_out_bytes": em.swap_out_bytes, "swap_in_bytes": em.swap_in_bytes,
                      "steps": em.steps, "wall_s": wall}
        if preempt:
            # the same swap again, timed to its end: out of slot 0, back in
            pool = eng._pool
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            host = pool.swap_out(0)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            pool.swap_in(host, 0)
            torch.cuda.synchronize(dev)
            runs[name]["swap_timed"] = {"bytes": _swap_bytes(host),
                                        "out_ms": 1e3 * (t1 - t0),
                                        "in_ms": 1e3 * (time.perf_counter() - t1)}
            del host, pool
        del eng, outs
        torch.cuda.empty_cache()
    on, off = runs["on"], runs["off"]
    require(sum(on["preemptions"]) >= 1, "no request was preempted")
    require(on["swap_in_bytes"] == on["swap_out_bytes"] > 0,
            f"swap bytes in {on['swap_in_bytes']} != out {on['swap_out_bytes']}")
    for i, n in enumerate(on["preemptions"]):
        if n:
            require(on["tokens"][i] == off["tokens"][i],
                    f"preempted request {i}: tokens {on['tokens'][i]} != {off['tokens'][i]}")
    res["preempt"] = {**runs, "victims": [i for i, n in enumerate(on["preemptions"]) if n],
                      "agreement": _agreement(off["tokens"], on["tokens"])}
    return res


# phase 4c: the other served archs and the other retrievers at full width,
# through the continuous scheduler, the pool in pinned host memory: 4
# needle requests over 4 slots, 16 greedy tokens each
ARCH_PROMPTS = (8192, 6144, 4096, 7168)
ARCH_NEW = 16
_POOLED = ("paged_attention", "select_pages", "fill_pages", "complete_page", "flash_prefill",
           "recall_gather")
WIDE_RUNS = {   # (arch, method, select_top_p) -> the kernels the run must launch
    ("qwen25-7b", "freekv", 0.0): _POOLED,
    ("gemma2-2b", "freekv", 0.0): _POOLED,
    ("smollm-360m", "freekv", 0.0): _POOLED,
    ("stablelm-3b", "freekv", 0.0): _POOLED,
    ("llama31-8b", "quest", 0.0): _POOLED,
    # RaaS: no pool; its prefill seeds the kept pages (fill_pages, a
    # select_pages and a recall_gather over the prompt's pages on the card)
    ("llama31-8b", "raas", 0.0): ("paged_attention", "select_pages", "fill_pages",
                                  "flash_prefill", "recall_gather"),
    ("llama31-8b", "streaming", 0.0): ("paged_attention", "flash_prefill"),
    ("llama31-8b", "infinigen", 0.0): _POOLED,
    ("llama31-8b", "freekv", 0.9): _POOLED,
    # MoE FFNs (64 routed experts top-6, 2 shared), MHA 16/16 at d_head 128
    ("deepseek-moe-16b", "freekv", 0.0): _POOLED,
}


def wide_run(dev, ops, cfg, params, method, top_p):
    """One phase-4c run: ``cfg`` at full width with seeded random bf16
    weights ``params``; every kernel the run takes must launch, and the
    scores-only, summary-only and centroid entries never; flash_prefill
    once a layer a prefill, complete_page once a global layer a decode step
    where the method keeps a pool. Returns (info, launches)."""
    from repro_torch.configs.base import ATTN, FreeKVConfig
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.obs import Observability
    from repro_torch.serving.engine import Request, ServeEngine

    fkv = FreeKVConfig(method=method, offload="host", select_top_p=top_p)
    reqs = [Request(uid=i, tokens=next(needle_stream(cfg.vocab_size, n, fkv.page_size,
                                                     seed=30 + i)).tokens,
                    max_new_tokens=ARCH_NEW) for i, n in enumerate(ARCH_PROMPTS)]
    eng = ServeEngine(cfg, fkv, params, max_len=max(ARCH_PROMPTS) + ARCH_NEW + P, batch_size=B,
                      state_dtype=torch.bfloat16, obs=Observability(enabled=True), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    em = eng.last_metrics
    run = f"{cfg.name} {method}" + (f" top_p {top_p}" if top_p else "")
    require(eng.last_logits_finite, f"non-finite logits ({run})")
    for o, r in zip(outs, reqs):
        require(len(o.tokens) == r.max_new_tokens
                and all(0 <= t < cfg.vocab_size for t in o.tokens),
                f"{run}: request {o.uid} made {len(o.tokens)} tokens or a bad one")
    need = WIDE_RUNS[(cfg.name, method, top_p)]
    for name in need:
        require(launches[name] > 0, f"{name} was never launched ({run})")
    for name in OFF_PATH + ("centroid_candidates", "recall_values", "recall_gather_quant",
                            "recall_values_quant"):
        require(launches[name] == 0, f"{name} launched ({run})")
    n_global = sum(m == ATTN for m, _ in cfg.layers)
    require(launches["flash_prefill"] == cfg.n_layers * len(reqs),
            f"flash_prefill launched {launches['flash_prefill']} times for {len(reqs)} prefills "
            f"of {cfg.n_layers} layers ({run})")
    if "complete_page" in need:
        require(launches["complete_page"] == n_global * em.steps,
                f"complete_page launched {launches['complete_page']} times for {em.steps} steps "
                f"of {n_global} global layers ({run})")
    lat = em.summary()["latency"]["decode_step_s"]
    gen_tokens = sum(len(o.tokens) for o in outs)
    info = {"arch": cfg.name, "method": method, "select_top_p": top_p, "slots": B,
            "layers": cfg.n_layers, "global_layers": n_global,
            "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.d_head],
            "prompt_tokens": list(ARCH_PROMPTS), "ttft_s": [o.metrics.ttft_s for o in outs],
            "decode_ms_per_step": 1e3 * lat["sum"] / lat["count"], "decode_steps": em.steps,
            "tokens_per_s": gen_tokens / wall, "wall_s": wall,
            "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "host_syncs_per_token": em.host_syncs / gen_tokens,
            "correction_rate": outs[0].stats.get("correction_rate"),
            "launches": launches, "first_tokens": outs[0].tokens[:8]}
    del eng, outs
    torch.cuda.empty_cache()
    return info, launches


def wide_runs(dev, ops, llama_cfg, llama):
    """Phase 4c: the five other archs under freekv (deepseek-moe-16b's
    weights freed after its run, as every arch's), then llama31-8b under
    quest, raas, streaming, infinigen and freekv with select_top_p 0.9.
    Each run's launches are its own (the counts set to 0 just before it);
    returns their sums by kernel, which the ``kernels`` line keeps apart
    from phase 4's main-path counts as ``wide_launches``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    totals = {}
    for (arch, method, top_p) in WIDE_RUNS:
        t0 = time.perf_counter()
        if arch == "llama31-8b":
            cfg, params = half_depth(llama_cfg, llama)
        else:
            cfg = half_depth(get_config(arch))
            params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
        info, run = wide_run(dev, ops, cfg, params, method, top_p)
        info["run_s"] = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
        for name, n in run.items():
            totals[name] = totals.get(name, 0) + n
        log("[wide] " + json.dumps(info))
        log(f"[wide] {arch} {method}{f' top_p {top_p}' if top_p else ''}: "
            f"TTFT {min(info['ttft_s']):.3f}-{max(info['ttft_s']):.3f} s, decode "
            f"{info['decode_ms_per_step']:.2f} ms/step over {info['decode_steps']} steps, "
            f"{info['tokens_per_s']:.2f} tokens/s, peak {info['peak_device_gib']:.2f} GiB, "
            f"{info['run_s']:.1f} s")
    return totals


# phase 4c, the xLSTM, encoder-decoder and frontend archs at full width:
# arch -> (prompt tokens, the kernels the run must launch). xlstm-350m's
# prompts are cut to 2048 tokens (its sLSTM prefill is a Python loop over
# time); it has no attention layer, so no kernel launches at all
XARCH_RUNS = {
    "whisper-tiny": (ARCH_PROMPTS, _POOLED),
    "xlstm-350m": ((2048,) * 4, ()),
    "internvl2-26b": (ARCH_PROMPTS, _POOLED),
}


def _frontend(cfg, rng):
    """Seeded stub embeddings for a frontend arch: 0.1 N(0, 1), numpy."""
    if cfg.frontend is None:
        return None
    return (0.1 * rng.standard_normal((cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)


def xarch_run(dev, ops, arch):
    """One phase-4c run of a new arch at full width with seeded random bf16
    weights (built here and freed after), freekv, the pinned pool, 4 slots,
    4 needle requests x 16 greedy tokens, each with its seeded frontend
    (whisper's 1500 frames, internvl2's 1024 patches). Every kernel the run
    takes must launch and no other: flash_prefill once an encoder and a
    decoder layer an admission, complete_page once a layer a decode step;
    xlstm none. internvl2's decode is then profiled (decode_profile's
    profile_decode on the same weights: host ops a step, busy share).
    Returns (info, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN, FreeKVConfig
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.models.model import frontend_prefix, init_params
    from repro_torch.obs import Observability
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = half_depth(get_config(arch))
    prompts, need = XARCH_RUNS[arch]
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    init_s = time.perf_counter() - t0
    fkv = FreeKVConfig(offload="host")
    rng = np.random.default_rng(41)
    reqs = [Request(uid=i, tokens=next(needle_stream(cfg.vocab_size, n, fkv.page_size,
                                                     seed=30 + i)).tokens,
                    max_new_tokens=ARCH_NEW, frontend=_frontend(cfg, rng))
            for i, n in enumerate(prompts)]
    eng = ServeEngine(cfg, fkv, params, max_len=frontend_prefix(cfg) + max(prompts) + ARCH_NEW + P,
                      batch_size=B, state_dtype=torch.bfloat16, obs=Observability(enabled=True),
                      device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    em = eng.last_metrics
    run = f"{arch} freekv"
    require(eng.last_logits_finite, f"non-finite logits ({run})")
    require(eng.prefill_chunk_tokens == 0 and eng.prefix_cache is None and not eng.spec_decode,
            f"{run}: chunked prefill, the prefix cache or spec decoding on")
    for o, r in zip(outs, reqs):
        require(len(o.tokens) == r.max_new_tokens
                and all(0 <= t < cfg.vocab_size for t in o.tokens),
                f"{run}: request {o.uid} made {len(o.tokens)} tokens or a bad one")
    for name, n in launches.items():
        require((n > 0) == (name in need), f"{name} launched {n} times ({run})")
    n_attn = sum(m == ATTN for m, _ in cfg.layers)
    n_enc = cfg.n_encoder_layers if cfg.is_encoder_decoder else 0
    if need:
        require(launches["flash_prefill"] == (n_attn + n_enc) * len(reqs),
                f"flash_prefill launched {launches['flash_prefill']} times for {len(reqs)} "
                f"admissions of {n_enc} encoder and {n_attn} decoder layers ({run})")
        require(launches["complete_page"] == n_attn * em.steps,
                f"complete_page launched {launches['complete_page']} times for {em.steps} steps "
                f"of {n_attn} layers ({run})")
    lat = em.summary()["latency"]["decode_step_s"]
    gen_tokens = sum(len(o.tokens) for o in outs)
    info = {"arch": arch, "method": "freekv", "slots": B, "layers": cfg.n_layers,
            "encoder_layers": n_enc, "frontend_tokens": cfg.n_frontend_tokens,
            "params_b": n_params / 1e9, "init_s": init_s,
            "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.d_head],
            "prompt_tokens": list(prompts), "ttft_s": [o.metrics.ttft_s for o in outs],
            "decode_ms_per_step": 1e3 * lat["sum"] / lat["count"], "decode_steps": em.steps,
            "tokens_per_s": gen_tokens / wall, "wall_s": wall,
            "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "host_syncs_per_token": em.host_syncs / gen_tokens,
            "launches": launches, "first_tokens": outs[0].tokens[:8]}
    del eng, outs
    torch.cuda.empty_cache()
    if arch == "internvl2-26b":
        from repro_torch.launch.decode_profile import profile_decode
        stream = needle_stream(cfg.vocab_size, CONTEXT, fkv.page_size, seed=0)
        toks = torch.from_numpy(np.stack([next(stream).tokens for _ in range(B)]))
        prof = profile_decode(cfg, fkv, params, toks.long().to(dev), steps=1, with_prefill=False)
        info["profile"] = {k: prof[k] for k in ("wall_ms_per_step_unprofiled",
                                                "cpu_ops_per_step", "device_ops_per_step",
                                                "device_busy_ms_per_step", "device_busy_share")}
    del params
    torch.cuda.empty_cache()
    return info, launches


def xarch_runs(dev, ops):
    """Phase 4c's xlstm-350m, whisper-tiny and internvl2-26b runs (each
    arch's weights freed after its run, after deepseek-moe-16b's); returns
    the sums of their launches by kernel."""
    totals = {}
    for arch in XARCH_RUNS:
        t0 = time.perf_counter()
        info, run = xarch_run(dev, ops, arch)
        info["run_s"] = time.perf_counter() - t0
        for name, n in run.items():
            totals[name] = totals.get(name, 0) + n
        log("[wide] " + json.dumps(info))
        log(f"[wide] {arch} freekv: TTFT {', '.join(f'{t:.3f}' for t in info['ttft_s'])} s, "
            f"decode {info['decode_ms_per_step']:.2f} ms/step over {info['decode_steps']} steps, "
            f"{info['tokens_per_s']:.2f} tokens/s, peak {info['peak_device_gib']:.2f} GiB, "
            f"{info['params_b']:.3f} B parameters, {info['run_s']:.1f} s")
        if "profile" in info:
            pr = info["profile"]
            log(f"[wide] {arch} freekv: eager decode step {pr['wall_ms_per_step_unprofiled']:.2f} "
                f"ms, {pr['cpu_ops_per_step']} host ops, {pr['device_ops_per_step']:.1f} device "
                f"operations, busy share {pr['device_busy_share']:.3f}")
    return totals


def time_low_rank_keys(dev, cfg, gen):
    """ShadowKV's prefill factorization at one layer's shape (B x 8192 keys
    per KV head, d 128, full rank as at llama widths): the port's
    ``low_rank_keys`` and the other routes to the same factors, each in
    CUDA-event ms per layer with its largest reconstruction error against
    the keys (singular vectors differ in sign between routes; u @ w not)."""
    from repro_torch.core.retrieval import low_rank_keys
    k = torch.randn(B, CONTEXT, cfg.n_kv_heads, cfg.d_head, generator=gen,
                    device=dev).to(torch.bfloat16)
    kf = k.transpose(1, 2).float()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def tall_svd():
        u, s_, vt = torch.linalg.svd(kf, full_matrices=False)
        return u * s_[..., None, :], vt

    def qr_svd():
        qm, rm = torch.linalg.qr(kf)
        u, s_, vt = torch.linalg.svd(rm)
        return (qm @ u) * s_[..., None, :], vt

    def gram_eigh():
        v = torch.linalg.eigh(kf.mT @ kf).eigenvectors.flip(-1)
        return kf @ v, v.mT

    # the port's route is the SVD of K with the gesvda driver
    routes = {"port low_rank_keys": lambda: low_rank_keys(k, cfg.d_head),
              "thin QR + SVD of R": qr_svd, "eigh of K^T K": gram_eigh,
              "SVD of K (default driver)": tall_svd}
    out = {}
    for name, fn in routes.items():
        fn()
        torch.cuda.synchronize()
        start.record()
        u, w = fn()
        stop.record()
        torch.cuda.synchronize()
        out[name] = {"ms_per_layer": start.elapsed_time(stop),
                     "max_abs_reconstruction_err": (u @ w - kf).abs().max().item()}
    port = out["port low_rank_keys"]
    require(port["max_abs_reconstruction_err"] < 1e-3,
            f"low_rank_keys: full-rank reconstruction error {port['max_abs_reconstruction_err']}")
    return {"layers": cfg.n_layers, "port_s_per_prefill": port["ms_per_layer"] * cfg.n_layers / 1e3,
            "routes": out}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _smoke_fkv(method, kv_quant):
    from repro_torch.configs.base import FreeKVConfig
    # centroid: re-center at every completed page, so the re-center runs here
    return FreeKVConfig(method=method, page_size=8, budget=64, n_sink=8, n_window=8,
                        offload="host", kv_quant=kv_quant, centroid_refresh_interval=1)


def kernel_vs_plain_end_to_end(dev, method, kv_quant):
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = get_config("granite-3-8b-smoke")
    fkv = _smoke_fkv(method, kv_quant)
    params_gpu = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    params_cpu = _tree_map(lambda t: t.cpu(), params_gpu)
    stream = needle_stream(cfg.vocab_size, 256, 8, seed=3)
    prompts = [next(stream).tokens for _ in range(2)]
    toks = {}
    for where, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        eng = ServeEngine(cfg, fkv, params, max_len=320, batch_size=2,
                          state_dtype=torch.float32, scheduler="static",
                          device=dev if where == "cuda" else "cpu")
        outs = eng.generate([Request(uid=i, tokens=t, max_new_tokens=16)
                             for i, t in enumerate(prompts)])
        toks[where] = [o.tokens for o in outs]
    require(toks["cuda"] == toks["cpu"], f"greedy tokens differ ({method}/{kv_quant}): "
            f"card {toks['cuda']} vs cpu {toks['cpu']}")
    return toks["cuda"]


def continuous_vs_plain(dev, method, kv_quant):
    """The continuous scheduler on the card against the CPU: granite-3-8b-
    smoke at float32, 5 requests of mixed lengths over 2 slots (slot
    turnover, an idle row stepping at the end), request 2 ended by an eos
    picked inside a window. Greedy tokens and step counts must be equal."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = get_config("granite-3-8b-smoke")
    fkv = _smoke_fkv(method, kv_quant)
    params_gpu = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    params_cpu = _tree_map(lambda t: t.cpu(), params_gpu)
    lens, news = (256, 200, 129, 256, 184), (16, 5, 12, 9, 7)
    prompts = [next(needle_stream(cfg.vocab_size, n, 8, seed=10 + i)).tokens
               for i, n in enumerate(lens)]

    def run(where, eos=None):
        eng = ServeEngine(cfg, fkv, params_gpu if where == "cuda" else params_cpu,
                          max_len=320, batch_size=2, state_dtype=torch.float32,
                          device=dev if where == "cuda" else "cpu")
        outs = eng.generate([Request(uid=i, tokens=t, max_new_tokens=m,
                                     eos_token=eos if i == 2 else None)
                             for i, (t, m) in enumerate(zip(prompts, news))])
        require(eng.last_logits_finite, f"non-finite logits ({where} {method}/{kv_quant})")
        return [o.tokens for o in outs], eng.last_metrics.steps, eng.last_metrics.host_syncs

    # request 2's eos: the first token it makes that it had not made before,
    # at its third token or later, so the eos is read inside a window
    toks2 = run("cpu")[0][2]
    eos = next(t for i, t in enumerate(toks2) if i >= 2 and t not in toks2[:i])
    got = {where: run(where, eos) for where in ("cuda", "cpu")}
    require(got["cuda"] == got["cpu"], f"continuous: card {got['cuda']} vs cpu {got['cpu']} "
            f"({method}/{kv_quant})")
    require(3 <= len(got["cuda"][0][2]) < news[2], "the eos did not end request 2 in a window")
    return got["cuda"]


def features_vs_plain(dev):
    """Chunked prefill, the prefix cache and preemption through the
    continuous scheduler on the card against the CPU: granite-3-8b-smoke at
    float32, greedy tokens (and chunk, hit and swap counts) equal; chunk
    budgets of a page, a token and a ragged 10 tokens, a prefix-cache hit,
    and a preemption under kv_quant none and int8, whose tokens also equal
    a run without it."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = get_config("granite-3-8b-smoke")
    params_gpu = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    params_cpu = _tree_map(lambda t: t.cpu(), params_gpu)

    def needle(n, seed):
        return next(needle_stream(cfg.vocab_size, n, 8, seed=seed)).tokens

    chunked = [Request(uid=i, tokens=needle(n, 80 + i), max_new_tokens=m)
               for i, (n, m) in enumerate(zip((72, 61, 64, 72, 58), (6, 5, 8, 4, 6)))]
    shared = needle(64, 90)
    cached = [Request(uid=i, tokens=np.concatenate(
        [shared, np.random.default_rng(91 + i).integers(0, cfg.vocab_size, t).astype(np.int32)]),
        max_new_tokens=6) for i, t in enumerate((16, 24, 16))]
    urgent = [Request(uid=i, tokens=needle(n, 95 + i), max_new_tokens=10, priority=int(i == 2))
              for i, n in enumerate((64, 96, 60))]
    # a bucket of a page keeps the reused span at the shared 64 tokens
    cases = [("chunk 8 (a page)", chunked, "none", dict(prefill_chunk_tokens=8), {}),
             ("chunk 1", chunked, "none", dict(prefill_chunk_tokens=1), {}),
             ("chunk 10", chunked, "none", dict(prefill_chunk_tokens=10), {}),
             ("prefix-cache hit", cached, "none", {},
              dict(prefix_cache_tokens=4096, prefill_bucket=8)),
             ("preempt none", urgent, "none", dict(preempt=True), {}),
             ("preempt int8", urgent, "int8", dict(preempt=True), {})]
    out = {}
    for name, reqs, kv_quant, fkv_kw, eng_kw in cases:
        fkv = dataclasses.replace(_smoke_fkv("freekv", kv_quant), **fkv_kw)
        got = {}
        for where in ("cuda", "cpu"):
            eng = ServeEngine(cfg, fkv, params_gpu if where == "cuda" else params_cpu,
                              max_len=160, batch_size=2, state_dtype=torch.float32,
                              device=dev if where == "cuda" else "cpu", **eng_kw)
            toks = [o.tokens for o in eng.generate(reqs)]
            em = eng.last_metrics
            require(eng.last_logits_finite, f"non-finite logits ({where} {name})")
            got[where] = (toks, em.prefill_chunks, [m.prefix_hit_tokens for m in em.requests],
                          em.preemptions, em.swap_out_bytes, em.swap_in_bytes)
        require(got["cuda"] == got["cpu"], f"{name}: card {got['cuda']} vs cpu {got['cpu']}")
        toks, chunks, hits, pre, swap_out, swap_in = got["cuda"]
        if fkv.prefill_chunk_tokens:
            require(chunks > len(reqs), f"{name}: {chunks} chunks")
        if eng_kw:
            require(hits[1:] == [64, 64], f"{name}: prefix hits {hits}")
        if fkv.preempt:
            require(pre >= 1 and swap_in == swap_out > 0, f"{name}: {pre} preemptions, "
                    f"swap bytes {swap_out} out, {swap_in} in")
            plain = ServeEngine(cfg, dataclasses.replace(fkv, preempt=False), params_gpu,
                                max_len=160, batch_size=2, state_dtype=torch.float32,
                                device=dev)
            require([o.tokens for o in plain.generate(reqs)] == toks,
                    f"{name}: tokens differ from the run without preemption")
        out[name] = {"chunks": chunks, "prefix_hit_tokens": hits, "preemptions": pre,
                     "swap_bytes": swap_out, "tokens": toks[0][:8]}
    return out


# phase 5 for the other archs and retrievers: (label, arch, method,
# select_top_p, real head layout, chunk budget)
NEW_PATHS = [("quest", "granite-3-8b-smoke", "quest", 0.0, False, 0),
             ("raas", "granite-3-8b-smoke", "raas", 0.0, False, 0),
             ("streaming", "granite-3-8b-smoke", "streaming", 0.0, False, 0),
             ("infinigen", "granite-3-8b-smoke", "infinigen", 0.0, False, 0),
             ("freekv top_p 0.9", "granite-3-8b-smoke", "freekv", 0.9, False, 0)] + [
    (f"{a}{' real heads' if real else ''}", f"{a}-smoke", "freekv", 0.0, real, 0)
    for a in ARCH_SHAPES if a not in XARCH_RUNS and a not in TP_SHAPES
    for real in (False, True)] + [
    ("gemma2-2b chunked 24", "gemma2-2b-smoke", "freekv", 0.0, False, 24)]


def new_paths_vs_plain(dev):
    """The other retrievers (on granite-3-8b-smoke) and the other archs (at
    smoke width and at their real head layouts, gemma2 also with a chunked
    prefill) through the continuous scheduler on the card against the CPU,
    float32: 4 requests of mixed lengths over 2 slots, greedy tokens and
    steps equal."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Request, ServeEngine
    out = {}
    for label, arch, method, top_p, real, chunk in NEW_PATHS:
        cfg = get_config(arch)
        if real:
            h, kv, d, _, _ = ARCH_SHAPES[arch[: -len("-smoke")]]
            cfg = dataclasses.replace(cfg, n_heads=h, n_kv_heads=kv, d_head=d)
        fkv = dataclasses.replace(_smoke_fkv(method, "none"), select_top_p=top_p,
                                  prefill_chunk_tokens=chunk)
        params_gpu = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
        params_cpu = _tree_map(lambda t: t.cpu(), params_gpu)
        prompts = [next(needle_stream(cfg.vocab_size, n, 8, seed=40 + i)).tokens
                   for i, n in enumerate((256, 200, 129, 256))]
        got = {}
        for where, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            eng = ServeEngine(cfg, fkv, params, max_len=320, batch_size=2,
                              state_dtype=torch.float32, device=dev if where == "cuda" else "cpu")
            outs = eng.generate([Request(uid=i, tokens=t, max_new_tokens=m)
                                 for i, (t, m) in enumerate(zip(prompts, (12, 5, 9, 7)))])
            require(eng.last_logits_finite, f"non-finite logits ({where} {label})")
            got[where] = ([o.tokens for o in outs], eng.last_metrics.steps,
                          eng.last_metrics.prefill_chunks)
        require(got["cuda"] == got["cpu"], f"{label}: card {got['cuda']} vs cpu {got['cpu']}")
        out[label] = {"arch": cfg.name, "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.d_head],
                      "steps": got["cuda"][1], "chunks": got["cuda"][2],
                      "tokens": got["cuda"][0][0][:8]}
    return out


# phase 5 for the MoE and hybrid archs: more requests than slots, so lanes
# idle and turn over and decode capacity binds (6 slots: 6 tokens x top-2
# over 4 experts at capacity 4; 8 slots for scout's top-1); (label, arch,
# slots, chunk budget, preempt, eos)
MOE_PATHS = [("6 slots", "deepseek-moe-16b-smoke", 6, 0, False, False),
             ("6 slots, chunked 24 (held lanes)", "deepseek-moe-16b-smoke", 6, 24, False, False),
             ("6 slots, an eos in a window, admissions queued", "deepseek-moe-16b-smoke", 6, 0,
              False, True),
             ("8 slots", "llama4-scout-17b-a16e-smoke", 8, 0, False, False),
             ("8 slots, chunked 24 (held lanes)", "llama4-scout-17b-a16e-smoke", 8, 24, False,
              False),
             ("6 slots", "jamba-1.5-large-398b-smoke", 6, 0, False, False),
             ("6 slots, a preemption", "jamba-1.5-large-398b-smoke", 6, 0, True, False)]


def moe_paths_vs_plain(dev):
    """The MoE archs and jamba through the continuous scheduler on the card
    against the CPU, float32 (MOE_PATHS): slots + 3 requests of mixed
    lengths, the last of priority 1 under preemption; with ``eos`` request
    2 ends by an eos picked inside a window (the window then reads the
    finishes every step and stops where the reference's does). Greedy
    tokens, steps, chunks, preemptions and swap bytes equal."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Request, ServeEngine
    lens, news = (128, 96, 160, 112), (12, 5, 9, 7, 14, 6, 10, 4, 11, 8, 13)
    out = {}
    for label, arch, slots, chunk, preempt, eos in MOE_PATHS:
        cfg = get_config(arch)
        fkv = dataclasses.replace(_smoke_fkv("freekv", "none"), prefill_chunk_tokens=chunk,
                                  preempt=preempt)
        params_gpu = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
        params_cpu = _tree_map(lambda t: t.cpu(), params_gpu)
        n = slots + 3
        prompts = [next(needle_stream(cfg.vocab_size, lens[i % 4], 8, seed=60 + i)).tokens
                   for i in range(n)]
        reqs = [Request(uid=i, tokens=t, max_new_tokens=news[i],
                        priority=int(preempt and i == n - 1)) for i, t in enumerate(prompts)]
        if eos:     # request 2's first new token at its third or later: inside a window
            toks2 = ServeEngine(cfg, fkv, params_cpu, max_len=320, batch_size=slots,
                                state_dtype=torch.float32, device="cpu").generate(reqs)[2].tokens
            reqs[2].eos_token = next(t for i, t in enumerate(toks2) if i >= 2
                                     and t not in toks2[:i])
        got = {}
        for where, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            eng = ServeEngine(cfg, fkv, params, max_len=320, batch_size=slots,
                              state_dtype=torch.float32, device=dev if where == "cuda" else "cpu")
            outs = eng.generate(reqs)
            em = eng.last_metrics
            require(eng.last_logits_finite, f"non-finite logits ({where} {arch} {label})")
            got[where] = ([o.tokens for o in outs], em.steps, em.prefill_chunks, em.preemptions,
                          em.swap_out_bytes, em.swap_in_bytes)
        require(got["cuda"] == got["cpu"], f"{arch} {label}: card {got['cuda']} vs cpu "
                f"{got['cpu']}")
        toks, steps, chunks, pre, swap_out, swap_in = got["cuda"]
        require(not chunk or chunks > n, f"{arch} {label}: {chunks} chunks")
        require(not preempt or (pre >= 1 and swap_in == swap_out > 0),
                f"{arch} {label}: {pre} preemptions, swap bytes {swap_out} / {swap_in}")
        require(not eos or 3 <= len(toks[2]) < news[2], f"{arch} {label}: the eos did not end "
                "request 2 in a window")
        out[f"{arch} {label}"] = {"requests": n, "steps": steps, "chunks": chunks,
                                  "preemptions": pre, "swap_bytes": swap_out,
                                  "tokens": toks[0][:8]}
    return out


# phase 5 for the xLSTM, encoder-decoder and frontend archs: (label, arch,
# real head layout); each through the continuous scheduler, the static path
# and a preemption
XARCH_PATHS = [("xlstm-350m", "xlstm-350m-smoke", False),
               ("whisper-tiny", "whisper-tiny-smoke", False),
               ("whisper-tiny real heads", "whisper-tiny-smoke", True),
               ("internvl2-26b", "internvl2-26b-smoke", False),
               ("internvl2-26b real heads", "internvl2-26b-smoke", True)]


def xarch_paths_vs_plain(dev):
    """xlstm-350m, whisper-tiny and internvl2-26b at smoke width, whisper
    and internvl2 also at their real head layouts, on the card against the
    CPU at float32: 5 requests of mixed lengths over 2 slots, four with
    seeded frontends and one without (zeros), through the continuous
    scheduler (slots turning over), the static path and a preemption (the
    last request of priority 1). Each engine is given a chunk budget and a
    prefix cache, which must read as off (as the reference sets them).
    Greedy tokens, steps, preemptions and swap bytes equal."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.models.model import frontend_prefix, init_params
    from repro_torch.serving.engine import Request, ServeEngine
    lens, news = (256, 200, 129, 256, 184), (12, 5, 9, 7, 6)
    out = {}
    for label, arch, real in XARCH_PATHS:
        cfg = get_config(arch)
        if real:
            h, kv, d, _, _ = ARCH_SHAPES[arch[: -len("-smoke")]]
            cfg = dataclasses.replace(cfg, n_heads=h, n_kv_heads=kv, d_head=d)
        params_gpu = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
        params_cpu = _tree_map(lambda t: t.cpu(), params_gpu)
        rng = np.random.default_rng(70)
        prompts = [next(needle_stream(cfg.vocab_size, n, 8, seed=70 + i)).tokens
                   for i, n in enumerate(lens)]
        fronts = [_frontend(cfg, rng) for _ in lens]
        fronts[2] = None
        max_len = frontend_prefix(cfg) + 320
        for case in ("continuous", "static", "preempt"):
            fkv = dataclasses.replace(_smoke_fkv("freekv", "none"), prefill_chunk_tokens=24,
                                      preempt=case == "preempt")
            reqs = [Request(uid=i, tokens=t, max_new_tokens=m, frontend=f,
                            priority=int(case == "preempt" and i == len(lens) - 1))
                    for i, (t, m, f) in enumerate(zip(prompts, news, fronts))]
            got = {}
            for where, params in (("cuda", params_gpu), ("cpu", params_cpu)):
                eng = ServeEngine(cfg, fkv, params, max_len=max_len, batch_size=2,
                                  state_dtype=torch.float32, prefix_cache_tokens=4096,
                                  scheduler="static" if case == "static" else "continuous",
                                  device=dev if where == "cuda" else "cpu")
                require(eng.prefill_chunk_tokens == 0 and eng.prefix_cache is None,
                        f"{label} {case}: the chunk budget or the prefix cache is on")
                outs = eng.generate(reqs)
                em = eng.last_metrics
                require(eng.last_logits_finite, f"non-finite logits ({where} {label} {case})")
                got[where] = ([o.tokens for o in outs], em.steps, em.prefill_chunks,
                              em.preemptions, em.swap_out_bytes, em.swap_in_bytes)
            require(got["cuda"] == got["cpu"], f"{label} {case}: card {got['cuda']} vs cpu "
                    f"{got['cpu']}")
            toks, steps, chunks, pre, swap_out, swap_in = got["cuda"]
            require(chunks == 0, f"{label} {case}: {chunks} prefill chunks")
            require(case != "preempt" or (pre >= 1 and swap_in == swap_out > 0),
                    f"{label} {case}: {pre} preemptions, swap bytes {swap_out} / {swap_in}")
            out[f"{label} {case}"] = {"arch": cfg.name,
                                      "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.d_head],
                                      "steps": steps, "preemptions": pre, "swap_bytes": swap_out,
                                      "tokens": toks[0][:8]}
        del params_gpu, params_cpu
    return out


def centroid_index_equals_rebuild(dev):
    """The centroid index kept step by step on the card (granite-3-8b-smoke,
    float32, a re-center at every completed page) equals
    ``centroid_index.rebuild`` on the card bit for bit, in every layer."""
    from repro_torch.configs import get_config
    from repro_torch.core import centroid_index
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.models.model import init_params, prefill, serve_step

    cfg = get_config("granite-3-8b-smoke")
    fkv = _smoke_fkv("centroid", "none")
    params = init_params(cfg, seed=1, device=dev, dtype=torch.float32)
    stream = needle_stream(cfg.vocab_size, 252, 8, seed=4)   # an unaligned prompt
    toks = torch.from_numpy(np.stack([next(stream).tokens for _ in range(2)])).long().to(dev)
    logits, state = prefill(cfg, fkv, params, {"tokens": toks}, 320, state_dtype=torch.float32)
    recentered = 0
    for _ in range(20):
        before = state["layers"][0]["cent_mean"].clone()
        logits, state = serve_step(cfg, fkv, params, state, torch.argmax(logits, -1)[:, None])
        recentered += int(not torch.equal(before, state["layers"][0]["cent_mean"]))
    require(recentered > 0, "the centroid index never re-centered")
    for i, st in enumerate(state["layers"]):
        rb = centroid_index.rebuild(st, fkv.page_size)
        for key in ("cent", "cent_assign", "cent_count"):
            require(torch.equal(rb[key], st[key]),
                    f"layer {i}: the kept {key} differs from its rebuild on the card")
    return recentered


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


# phase 4d: the reference's sampled key streams and speculative decoding at
# full width: llama31-8b bf16, freekv/none, pinned pool, recall overlap,
# continuous scheduler over 4 slots, the first four phase-4 needle prompts
SPEC_PROMPTS = CONT_PROMPTS[:4]
SPEC_NEW = 16
SPEC_TEMPERATURE, SPEC_TOP_P = 0.8, 0.9


def _ulp(x, dt):
    """The spacing of ``dt`` at the float32 values ``x``."""
    mant = 7 if dt == torch.bfloat16 else 23
    e = torch.floor(torch.log2(x.abs().clamp_min(torch.finfo(dt).tiny)))
    return torch.exp2(e - mant)


def check_sampler(dev, vocab, padded):
    """(a) Seeded bf16 and fp32 logits at llama31-8b's padded vocabulary
    (the padded lanes at finfo.min) through ``sample_step`` (a key a row:
    4 rows, and 20 = a verify pass's S * B) and ``sample`` (one key) on the
    card and on the CPU. Keys and random bits must be equal; drawn ids
    too, except where the CPU's top two perturbed logits lie within 4 ulp
    of each other: those are counted and printed, as are rows where top-p
    kept a different count on the card (no exemption)."""
    from repro_torch.serving import sampling
    keys = torch.stack([sampling.request_key(0, u) for u in range(20)])
    counts = torch.arange(20, dtype=torch.int32) * 7
    sk = sampling.step_keys(keys, counts)
    sk_dev = sampling.step_keys(keys.to(dev), counts.to(dev))
    require(torch.equal(sk, sk_dev.cpu()), "step keys differ between the card and the CPU")
    for width in (8, 32):
        for k_cpu, k_dev, shape in ((sk, sk_dev, (padded,)), (sk[0], sk_dev[0], (4, padded))):
            require(torch.equal(sampling.random_bits(k_cpu, width, shape),
                                sampling.random_bits(k_dev, width, shape).cpu()),
                    f"random bits differ between the card and the CPU ({width} bits, {shape})")
    g = torch.Generator().manual_seed(11)
    out = {"rows": {}, "ms": {}}
    for dt in (torch.bfloat16, torch.float32):
        base = torch.randn((20, padded), generator=g) * 3
        logits = base.to(dt)
        logits[:, vocab:] = torch.finfo(dt).min
        ld = logits.to(dev)
        for top_p in (1.0, SPEC_TOP_P):
            cfg = sampling.SamplerConfig(SPEC_TEMPERATURE, top_p)
            label = f"{str(dt).split('.')[-1]} top_p {top_p}"
            got = {"step": (sampling.sample_step(logits, cfg, sk),
                            sampling.sample_step(ld, cfg, sk_dev).cpu()),
                   "one_key": (sampling.sample(logits[:4], cfg, sk[0]),
                               sampling.sample(ld[:4], cfg, sk_dev[0]).cpu())}
            filt = sampling._filter_logits(logits, cfg)
            kept = torch.isfinite(filt).sum(-1)
            kept_dev = torch.isfinite(sampling._filter_logits(ld, cfg)).sum(-1).cpu()
            pert = {"step": sampling.gumbel(sk, (padded,), dt) + filt,
                    "one_key": sampling.gumbel(sk[0], (4, padded), dt) + filt[:4]}
            tally = {"draws": 0, "equal": 0, "near_tie": 0, "top_p_kept_differs": 0}
            for what, (a, b) in got.items():
                top2 = torch.topk(pert[what].float(), 2, dim=-1).values
                tie = (top2[:, 0] - top2[:, 1]) <= 4 * _ulp(top2[:, 0], dt)
                tally["draws"] += a.numel()
                tally["equal"] += int((a == b).sum())
                tally["near_tie"] += int(((a != b) & tie).sum())
                tally["top_p_kept_differs"] += int((kept != kept_dev)[:a.shape[0]].sum())
                require(bool(((a == b) | tie).all()),
                        f"sampled ids differ between the card and the CPU ({label}, {what}): "
                        f"{a.tolist()} vs {b.tolist()}")
            out["rows"][label] = tally
            for rows in (4, 20):
                dev_ms, call_ms = time_ms(lambda lg, k: sampling.sample_step(lg, cfg, k),
                                          [(ld[:rows], sk_dev[:rows])], iters=10)
                out["ms"][f"{label} rows {rows}"] = {"device_ms": dev_ms, "call_ms": call_ms}
    return out


def _spec_requests(cfg, hints=None):
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.serving.engine import Request
    return [Request(uid=i, tokens=next(needle_stream(cfg.vocab_size, n, P, seed=i)).tokens,
                    max_new_tokens=SPEC_NEW, draft_hint=None if hints is None else hints[i])
            for i, n in enumerate(SPEC_PROMPTS)]


def spec_run(dev, ops, cfg, params, draft_len, temperature=0.0, hints=None):
    """One run of phase 4d with the counts set to 0 just before it and
    read just after. A verify iteration launches, a layer, S = 1 +
    draft_len times what a decode step does (select_pages 1, recall_gather
    2: top-up and staged, paged_attention 1, complete_page 1) and one
    recall_gather more, the rollback's; each admission's prefill one
    flash_prefill, fill_pages, select_pages and recall_gather a layer."""
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.obs import Observability
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.sampling import SamplerConfig

    fkv = FreeKVConfig(method="freekv", offload="host", draft_len=draft_len)
    sampler = (SamplerConfig(temperature, SPEC_TOP_P) if temperature else SamplerConfig())
    reqs = _spec_requests(cfg, hints)
    eng = ServeEngine(cfg, fkv, params, max_len=MAX_LEN, batch_size=B,
                      state_dtype=torch.bfloat16, sampler=sampler,
                      obs=Observability(enabled=True), device=dev)
    require(eng.spec_decode == (draft_len > 0), "spec decoding fell back on the main path")
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    em = eng.last_metrics
    sd = em.summary()["specdec"]
    require(eng.last_logits_finite, f"non-finite logits (draft_len {draft_len})")
    L, S, n_pre = cfg.n_layers, draft_len + 1, len(reqs)
    iters = sd["verify_steps"] + sd["idle_iterations"] if draft_len else em.steps
    want = {"flash_prefill": L * n_pre, "fill_pages": L * n_pre,
            "complete_page": L * S * iters, "paged_attention": L * S * iters,
            "select_pages": L * (S * iters + n_pre),
            "recall_gather": L * ((2 * S + (1 if draft_len else 0)) * iters + n_pre)}
    for name, n in want.items():
        require(launches[name] == n, f"{name} launched {launches[name]} times, {n} expected "
                f"(draft_len {draft_len}, {iters} iterations of {S} rows)")
    for name in OFF_PATH + ("recall_gather_quant", "recall_values", "recall_values_quant",
                            "centroid_candidates"):
        require(launches[name] == 0, f"{name} launched under spec decoding")
    gen_tokens = sum(len(o.tokens) for o in outs)
    committed = gen_tokens - len(outs)          # the first tokens come from the prefills
    decode_s = wall - sum(o.prefill_s for o in outs)
    info = {"draft_len": draft_len, "layers": cfg.n_layers, "temperature": temperature,
            "hinted": hints is not None,
            "tokens": [o.tokens for o in outs], "accept_rate": sd["accept_rate"],
            "tokens_per_target_step": sd["tokens_per_step"],
            "verify_steps": sd["verify_steps"], "idle_iterations": sd["idle_iterations"],
            "steps": em.steps, "decode_ms_per_committed_token": 1e3 * decode_s / committed,
            "host_reads_per_token": em.host_syncs / gen_tokens, "host_syncs": em.host_syncs,
            "tokens_per_s": gen_tokens / wall, "wall_s": wall,
            "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "launches": launches}
    del eng, outs
    torch.cuda.empty_cache()
    return info, launches


def verify_rows_vs_steps(dev, cfg, params):
    """A verify pass's rows against S sequential ``serve_step`` calls from
    the same state, at the main path's B = 4 (2048-token needle prompts,
    two identical prefills): they must be equal bit for bit (logits and
    stats). Beside it, what the port's row-by-row verify avoids: layer 0's
    bf16 FFN up-projection over the B * S rows in one GEMM (the
    reference's batched form) against S GEMMs at M = B, reported."""
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.models.model import prefill, serve_step, serve_step_verify

    fkv = FreeKVConfig(method="freekv", offload="host", draft_len=4)
    stream = needle_stream(cfg.vocab_size, 2048, P, seed=5)
    toks = torch.from_numpy(np.stack([next(stream).tokens for _ in range(B)])).long().to(dev)
    g = torch.Generator().manual_seed(3)
    block = torch.randint(0, cfg.vocab_size, (B, 5), generator=g).to(dev)

    def state():
        return prefill(cfg, fkv, params, {"tokens": toks}, 2048 + 64,
                       state_dtype=torch.bfloat16)[1]
    st = state()
    single, sstats = [], []
    for j in range(5):
        lg, st, s = serve_step(cfg, fkv, params, st, block[:, j:j + 1], collect_stats=True)
        single.append(lg)
        sstats.append(s)
    del st
    logits, st, rows, _ = serve_step_verify(cfg, fkv, params, state(), block)
    out = {"rows_bitwise_equal": [bool(torch.equal(logits[:, j], single[j])) for j in range(5)],
           "stats_equal": all(torch.equal(rows[k][j], sstats[j][k])
                              for j in range(5) for k in rows)}
    del st, logits
    torch.cuda.empty_cache()
    w = params["layers"][0]["ffn"]["up"]
    h = torch.randn((5 * B, w.shape[0]), generator=g).to(dev, torch.bfloat16)
    one = h @ w
    per_m = torch.cat([h[j * B:(j + 1) * B] @ w for j in range(5)])
    out["gemm_m20_vs_m4"] = {"bitwise_equal": bool(torch.equal(one, per_m)),
                             "max_abs_diff": float((one.float() - per_m.float()).abs().max())}
    require(all(out["rows_bitwise_equal"]) and out["stats_equal"],
            f"a verify pass's rows differ from single steps: {json.dumps(out)}")
    return out


def spec_phase(dev, ops, cfg, params):
    """Phase 4d: (a) the sampler, card against CPU; (b) greedy spec
    decoding at draft_len 0, 2 and 4, then 4 with each request's
    ``draft_hint`` its draft_len=0 output, tokens equal across the four;
    the verify rows against single steps; (c) sampled (temperature 0.8,
    top-p 0.9), draft_len 0 against 4 with the hint, tokens equal. Returns
    the runs' summed launches."""
    t_phase = time.perf_counter()
    smp = check_sampler(dev, cfg.vocab_size, cfg.padded_vocab())
    log("[spec] sampler card vs cpu: keys and random bits equal; ids " + json.dumps(smp["rows"]))
    log("[spec] sampler ms on the card (device, call): " + json.dumps(smp["ms"]))
    rows = verify_rows_vs_steps(dev, cfg, params)
    log("[spec] verify rows vs single steps (B=4, S=5): " + json.dumps(rows))
    totals, runs = {}, {}

    def add(key, info, run):
        runs[key] = info
        for name, n in run.items():
            totals[name] = totals.get(name, 0) + n
        log(f"[spec] {key}: accept rate {info['accept_rate']:.3f}, "
            f"{info['tokens_per_target_step']:.2f} tokens a target step, "
            f"{info['verify_steps']} verify steps + {info['idle_iterations']} idle, "
            f"{info['steps']} steps, decode {info['decode_ms_per_committed_token']:.2f} ms a "
            f"committed token, {info['host_reads_per_token']:.4f} host reads a token, "
            f"{info['tokens_per_s']:.2f} tokens/s, peak {info['peak_device_gib']:.2f} GiB, "
            f"launches {json.dumps({k: v for k, v in info['launches'].items() if v})}")
    for dl in (0, 2, 4):
        add(f"greedy draft_len {dl}", *spec_run(dev, ops, cfg, params, dl))
    base = runs["greedy draft_len 0"]["tokens"]
    prompts = [r.tokens for r in _spec_requests(cfg)]
    hints = [np.concatenate([p[-1:], np.asarray(t, np.int32)]) for p, t in zip(prompts, base)]
    add("greedy draft_len 4 hinted", *spec_run(dev, ops, cfg, params, 4, hints=hints))
    for key in ("greedy draft_len 2", "greedy draft_len 4", "greedy draft_len 4 hinted"):
        require(runs[key]["tokens"] == base, f"{key} tokens differ from draft_len 0's: "
                f"{runs[key]['tokens']} vs {base}")
    add("sampled draft_len 0", *spec_run(dev, ops, cfg, params, 0, SPEC_TEMPERATURE))
    sbase = runs["sampled draft_len 0"]["tokens"]
    shints = [np.concatenate([p[-1:], np.asarray(t, np.int32)]) for p, t in zip(prompts, sbase)]
    add("sampled draft_len 4 hinted",
        *spec_run(dev, ops, cfg, params, 4, SPEC_TEMPERATURE, hints=shints))
    require(runs["sampled draft_len 4 hinted"]["tokens"] == sbase,
            "sampled draft_len 4 tokens differ from draft_len 0's")
    require(sbase != base, "the sampled run drew the greedy tokens")
    log(f"[spec] tokens equal across greedy draft_len 0/2/4/4-hinted and sampled 0/4-hinted; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return totals


def spec_vs_plain(dev):
    """Speculative decoding on the card against the CPU: granite-3-8b-smoke
    at float32, continuous, 5 requests over 2 slots, draft_len 3, greedy
    (none and int8) and sampled; the tokens must equal the CPU's and
    draft_len 0's."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.serving.sampling import SamplerConfig

    cfg = get_config("granite-3-8b-smoke")
    params_gpu = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    params_cpu = _tree_map(lambda t: t.cpu(), params_gpu)
    lens, news = (256, 200, 129, 256, 184), (16, 5, 12, 9, 7)
    prompts = [next(needle_stream(cfg.vocab_size, n, 8, seed=10 + i)).tokens
               for i, n in enumerate(lens)]
    out = {}
    for kv_quant, temp in (("none", 0.0), ("int8", 0.0), ("none", SPEC_TEMPERATURE)):
        toks = {}
        for where, dl in (("cuda", 3), ("cpu", 3), ("cuda", 0)):
            fkv = dataclasses.replace(_smoke_fkv("freekv", kv_quant), draft_len=dl)
            eng = ServeEngine(cfg, fkv, params_gpu if where == "cuda" else params_cpu,
                              max_len=320, batch_size=2, state_dtype=torch.float32,
                              sampler=SamplerConfig(temp, SPEC_TOP_P if temp else 1.0),
                              device=dev if where == "cuda" else "cpu")
            outs = eng.generate([Request(uid=i, tokens=t, max_new_tokens=m)
                                 for i, (t, m) in enumerate(zip(prompts, news))])
            toks[(where, dl)] = [o.tokens for o in outs]
        label = f"{kv_quant} temperature {temp}"
        require(toks[("cuda", 3)] == toks[("cpu", 3)] == toks[("cuda", 0)],
                f"spec decoding card vs cpu ({label}): {toks}")
        out[label] = toks[("cuda", 3)][0][:8]
    return out


# phase 4e: live serving at full width through the HTTP front-end:
# llama31-8b bf16, freekv/none, pinned pool, recall overlap, continuous over
# 4 slots, the same max_len as phase 4, Observability.full() (trace and
# board), SLOs of 2000 ms TTFT and 500 ms mean inter-token latency. Nine
# streaming clients, a thread each, arrive on a seeded exponential schedule
# (mean gap 0.5 s, a chat service whose users come over time): phase 4's
# eight needle requests and, arriving third, a ninth that hangs up after
# its 4th token
SERVE_GAP_S = 0.5
SERVE_SLO_MS = (2000.0, 500.0)
SERVE_QUITTER = (8, 4096, 64, 4)        # uid, prompt tokens, new tokens, tokens it reads
SERVE_ORDER = (0, 1, 8, 2, 3, 4, 5, 6, 7)


def _prometheus_problems(text):
    """The text exposition's line rules: a ``# TYPE`` is counter, gauge or
    histogram; every other line that is not a comment is ``name[{labels}]
    value`` with a finite value."""
    problems, samples = [], 0
    for i, ln in enumerate(text.splitlines(), 1):
        if not ln.strip():
            continue
        if ln.startswith("# TYPE "):
            if ln.split()[-1] not in ("counter", "gauge", "histogram"):
                problems.append(f"line {i}: unknown metric type")
            continue
        if ln.startswith("#"):
            continue
        parts = ln.rsplit(" ", 1)
        try:
            ok = len(parts) == 2 and math.isfinite(float(parts[1]))
        except ValueError:
            ok = False
        if not ok:
            problems.append(f"line {i}: not 'name value' with a finite value: {ln[:80]}")
        samples += 1
    return problems if samples else problems + ["no sample"]


def _ndjson_events(buf):
    """The complete JSON events in the bytes of a chunked NDJSON stream."""
    out = []
    for piece in buf.split(b"\r\n"):
        piece = piece.strip()
        if piece.startswith(b"{") and piece.endswith(b"}"):
            out.append(json.loads(piece))
    return out


def _serve_client(port, payload, quit_after, out):
    """One streaming client: posts ``payload`` and records each event with
    its arrival time (s from the request's start); with ``quit_after``, it
    reads that many tokens and closes its socket."""
    import socket

    from repro_torch.serving.frontend import http_generate
    t0 = time.perf_counter()
    rec = out[payload["uid"]] = {"events": [], "t": [], "error": None}
    try:
        if quit_after is None:
            for ev in http_generate("127.0.0.1", port, payload, timeout=600):
                rec["events"].append(ev)
                rec["t"].append(time.perf_counter() - t0)
            return
        body = json.dumps({**payload, "stream": True}).encode()
        s = socket.create_connection(("127.0.0.1", port), timeout=600)
        s.sendall(b"POST /generate HTTP/1.1\r\nHost: c\r\nContent-Type: application/json\r\n"
                  b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
            evs = _ndjson_events(buf)
            rec["t"] += [time.perf_counter() - t0] * (len(evs) - len(rec["events"]))
            rec["events"] = evs
            if sum(e["event"] == "token" for e in evs) >= quit_after:
                break
        s.close()                       # the user gives up
    except Exception as e:              # read by the phase, which fails on it
        rec["error"] = repr(e)


def serve_phase(dev, ops, cfg, params, direct_tokens, direct_ms):
    """Phase 4e (see SERVE_*): the eight survivors' streamed tokens must
    equal phase 4's continuous freekv/none tokens ``direct_tokens``; the
    ninth must end CANCELLED with ``sched_cancellations_total`` 1 and its
    tokens a prefix of a direct run's; every slot free; no client error and
    no worker failure (``EngineService.stop()`` raises it); /healthz,
    /metrics and /stats valid while requests are in flight; the main path's
    kernels launched as phase 4 requires (flash_prefill and fill_pages once
    a layer a prefill, complete_page once a layer a step), the counts set
    to 0 just before the service starts and read when it stops; the trace
    and the JSONL snapshot valid. Then the same nine requests go through
    ``generate()`` on the same engine, the hung-up one for the tokens the
    server made: all tokens equal, and its decode ms/step stands beside the
    service's. Returns (info, launches)."""
    import tempfile
    import threading

    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.obs import (Observability, validate_chrome_trace, validate_snapshot,
                                 validate_timeseries_snapshot)
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.serving.frontend import (EngineService, http_get_json, http_get_text,
                                              serve_http_background)

    t_phase = time.perf_counter()
    fkv = FreeKVConfig(method="freekv", offload="host")
    quid, qlen, qnew, qread = SERVE_QUITTER
    spec = {i: (n, m) for i, (n, m) in enumerate(zip(CONT_PROMPTS, CONT_NEW))}
    spec[quid] = (qlen, qnew)
    prompts = {u: next(needle_stream(cfg.vocab_size, n, fkv.page_size, seed=u)).tokens
               for u, (n, _) in spec.items()}
    obs = Observability.full()
    eng = ServeEngine(cfg, fkv, params, max_len=MAX_LEN, batch_size=B,
                      state_dtype=torch.bfloat16, obs=obs, slo_ttft_ms=SERVE_SLO_MS[0],
                      slo_itl_ms=SERVE_SLO_MS[1], device=dev)
    gaps = np.random.default_rng(0).exponential(SERVE_GAP_S, len(SERVE_ORDER))
    gaps[0] = 0.0
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    svc = EngineService(eng, seed=0).start()
    fe, stop, th = serve_http_background(svc)
    results, clients, live = {}, [], {}
    for k, (uid, gap) in enumerate(zip(SERVE_ORDER, gaps)):
        time.sleep(gap)
        payload = {"uid": uid, "tokens": prompts[uid].tolist(), "max_new_tokens": spec[uid][1]}
        c = threading.Thread(target=_serve_client,
                             args=(fe.port, payload, qread if uid == quid else None, results))
        c.start()
        clients.append(c)
        if k == 5:                      # six requests in, tokens out: the live endpoints
            live["healthz"] = http_get_json("127.0.0.1", fe.port, "/healthz")
            live["metrics"] = http_get_text("127.0.0.1", fe.port, "/metrics")
            live["stats"] = http_get_json("127.0.0.1", fe.port, "/stats")
    for c in clients:
        c.join(timeout=600)
        require(not c.is_alive(), "a serving client did not finish")
    stop.set()
    th.join(timeout=60)
    completions = svc.stop()            # raises the worker's failure
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    em = eng.last_metrics
    by_uid = {c.uid: c for c in completions}

    st, hz = live["healthz"]
    require(st == 200 and hz["ok"] and hz["engine_running"], f"/healthz in flight: {st} {hz}")
    st, prom = live["metrics"]
    require(st == 200 and not _prometheus_problems(prom),
            f"/metrics in flight: {st} {_prometheus_problems(prom)[:5]}")
    st, stats = live["stats"]
    require(st == 200 and not validate_timeseries_snapshot(stats)
            and stats["rates"].get("tokens", {}).get("total_events", 0) > 0
            and "ttft_s" in stats["stats"],
            f"/stats in flight: {st} {validate_timeseries_snapshot(stats)} {stats.get('rates')}")
    for uid, rec in results.items():
        require(rec["error"] is None, f"client {uid}: {rec['error']}")
        require(not any(e["event"] == "error" for e in rec["events"]),
                f"client {uid} saw an error event: {rec['events'][-1]}")
    ttft, gaps_s = [], []
    for uid in spec:
        if uid == quid:
            continue
        evs, ts = results[uid]["events"], results[uid]["t"]
        toks = [e["token"] for e in evs if e["event"] == "token"]
        require(evs[-1]["event"] == "done" and evs[-1]["tokens"] == toks,
                f"client {uid}: the stream ended {evs[-1]['event']}")
        require(toks == direct_tokens[uid], f"request {uid}: served tokens {toks} differ from "
                f"phase 4's {direct_tokens[uid]}")
        t_tok = [t for e, t in zip(evs, ts) if e["event"] == "token"]
        ttft.append(t_tok[0])
        gaps_s += list(np.diff(t_tok))
    quitter = by_uid[quid]
    read = [e["token"] for e in results[quid]["events"] if e["event"] == "token"]
    require(quitter.metrics.cancelled and em.cancellations == 1
            and em.registry.snapshot()["counters"]["sched_cancellations_total"] == 1,
            f"the hung-up request: cancelled {quitter.metrics.cancelled}, cancellations "
            f"{em.cancellations}")
    require(len(read) >= qread and quitter.tokens[:len(read)] == read
            and len(quitter.tokens) < qnew,
            f"the hung-up request read {read}, the server made {quitter.tokens}")
    require(eng._pool.owner == [None] * B and eng._pool.free_count == B,
            f"slots still held after the run: {eng._pool.owner}")
    require(all(not by_uid[u].metrics.cancelled for u in spec if u != quid),
            "a survivor was cancelled")
    for name in RUNS[("freekv", "none")]:
        require(launches[name] > 0, f"{name} was never launched while serving")
    for name in OFF_PATH + ("recall_gather_quant", "recall_values", "recall_values_quant",
                            "centroid_candidates"):
        require(launches[name] == 0, f"{name} launched while serving")
    for name, per_layer in (("flash_prefill", len(spec)), ("fill_pages", len(spec)),
                            ("complete_page", em.steps)):
        require(launches[name] == cfg.n_layers * per_layer,
                f"{name} launched {launches[name]} times while serving, "
                f"{cfg.n_layers} x {per_layer} expected")
    with tempfile.TemporaryDirectory() as tmp:
        trace_path, snap_path = os.path.join(tmp, "trace.json"), os.path.join(tmp, "m.jsonl")
        obs.trace.write(trace_path)
        em.registry.write_jsonl(snap_path, extra={"phase": "4e"})
        with open(trace_path, encoding="utf-8") as f:
            problems = validate_chrome_trace(json.load(f))
        require(not problems, f"the served trace: {problems[:5]}")
        with open(snap_path, encoding="utf-8") as f:
            for ln in f:
                problems = validate_snapshot(json.loads(ln))
                require(not problems, f"the JSONL snapshot: {problems[:5]}")
        trace_events = len(obs.trace.events)
    summary = em.summary()
    lat = summary["latency"]["decode_step_s"]
    gen_tokens = sum(len(c.tokens) for c in completions)
    # the same nine requests handed to generate() on the same engine, the
    # hung-up one for the tokens the server made: its tokens must be those,
    # and the decode's ms/step is the same engine's without the front-end
    direct = eng.generate([Request(uid=u, tokens=prompts[u], max_new_tokens=(
        len(quitter.tokens) if u == quid else m)) for u, (_, m) in spec.items()])
    dtoks = {c.uid: c.tokens for c in direct}
    require(dtoks == {**direct_tokens, quid: quitter.tokens},
            f"the direct run of the nine requests differs: the hung-up request's "
            f"{quitter.tokens} against {dtoks[quid]}")
    dlat = eng.last_metrics.summary()["latency"]["decode_step_s"]
    pct = lambda xs, q: float(np.percentile(xs, q))     # noqa: E731
    info = {"requests": len(spec), "arrival_order": list(SERVE_ORDER),
            "arrival_gaps_s": [float(g) for g in gaps],
            "client_ttft_s": {"p50": pct(ttft, 50), "p99": pct(ttft, 99), "max": max(ttft)},
            "client_token_gap_s": {"p50": pct(gaps_s, 50), "p99": pct(gaps_s, 99),
                                   "max": max(gaps_s)},
            "slo": em.slo_summary(), "server_ttft_s": summary["latency"]["ttft_s"],
            "decode_ms_per_step": 1e3 * lat["sum"] / lat["count"],
            "direct_decode_ms_per_step": direct_ms,
            "same_engine_direct_decode_ms_per_step": 1e3 * dlat["sum"] / dlat["count"],
            "same_engine_direct_steps": eng.last_metrics.steps, "decode_steps": em.steps,
            "host_syncs": em.host_syncs, "host_syncs_per_token": em.host_syncs / gen_tokens,
            "generated_tokens": gen_tokens, "tokens_per_s": gen_tokens / wall, "wall_s": wall,
            "hung_up": {"read": len(read), "server_tokens": len(quitter.tokens)},
            "slot_occupancy": em.slot_occupancy, "peak_device_gib": peak,
            "trace_events": trace_events,
            "stats_in_flight": {k: stats["rates"].get(k, {}).get("total_events")
                                for k in ("tokens", "completions")},
            "launches": launches, "phase_s": time.perf_counter() - t_phase}
    del eng, completions, direct
    torch.cuda.empty_cache()
    return info, launches


# ---------------------------------------------------------------------------
# phase 4f: KV-head-group tensor parallelism at full width. llama31-8b's 8
# KV heads over TP shards (4 a shard, G 4, d 128): every retrieval kernel
# runs once a shard where tp=1 runs it once, at the shard's head layout
# (phase 3's TP_SHAPES); the backbone, and so flash_prefill, runs once
# ---------------------------------------------------------------------------
TP = 2
TP_DOUBLED = ("paged_attention", "select_pages", "fill_pages", "complete_page")


def tp_run(dev, ops, cfg, params, kv_quant, devices, ref, profile=False):
    """Phase 4's eight requests through ``ServeEngine`` over a TP-shard mesh
    on ``devices``, freekv/``kv_quant``, pinned pool, recall overlap,
    continuous over B slots, held against phase 4's tp=1 run ``ref`` of the
    same method, quantization and depth: tokens and steps equal, exposed
    and hidden bytes equal, each shard's measured transfer bytes adding up
    to them and equal to the flight tracker's, every retrieval kernel launched exactly TP times as often and
    flash_prefill as often, each shard's pool holding a page only a decode
    completion writes. ``profile``: a few eager decode steps profiled as
    phase 4's (host ops, busy share)."""
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.obs import Observability
    from repro_torch.serving.engine import ServeEngine

    fkv = FreeKVConfig(method="freekv", offload="host", kv_quant=kv_quant)
    reqs = main_requests(cfg, fkv)
    mesh = make_tp_mesh(TP, devices)
    run = f"tp{TP} on {','.join(str(d) for d in mesh.devices)} freekv/{kv_quant}"
    eng = ServeEngine(cfg, fkv, params, max_len=MAX_LEN, batch_size=B,
                      state_dtype=torch.bfloat16, obs=Observability(enabled=True), device=dev,
                      mesh=mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    em = eng.last_metrics
    s = em.summary()
    require(eng.last_logits_finite, f"non-finite logits ({run})")
    tokens = {o.uid: o.tokens for o in outs}
    require(tokens == ref["tokens"], f"{run}: tokens {tokens} differ from phase 4's tp=1 "
            f"{ref['tokens']}")
    require(em.steps == ref["info"]["decode_steps"],
            f"{run}: {em.steps} steps, phase 4's tp=1 {ref['info']['decode_steps']}")
    ro, ref_ro = s["recall_overlap"], ref["info"]["recall_overlap"]
    for key in ("exposed_bytes", "hidden_bytes", "dropped_in_flight_bytes"):
        require(ro[key] == ref_ro[key], f"{run}: {key} {ro[key]}, phase 4's tp=1 {ref_ro[key]}")
    shard, flight = s["tp"]["shard_transfer_bytes"], eng.recall_tracker.summary()["shards"]
    require(s["tp"]["tp"] == TP, f"{run}: summary()['tp'] {s['tp']}")
    for cls, total, tracked in (("sync", "exposed_bytes", "topup_pages"),
                                ("async", "hidden_bytes", "staged_pages"),
                                ("dropped", "dropped_in_flight_bytes", "dropped_pages")):
        require(len(shard[cls]) == TP and sum(shard[cls]) == ro[total],
                f"{run}: the shards' {cls} bytes {shard[cls]} do not add up to {ro[total]}")
        require([n * em.page_block_bytes for n in flight[tracked]] == shard[cls],
                f"{run}: the flight tracker's {tracked} {flight[tracked]} disagree with the "
                f"shards' {cls} bytes {shard[cls]}")
    gather = "recall_gather" if kv_quant == "none" else "recall_gather_quant"
    for name in TP_DOUBLED + (gather,):
        require(launches[name] == TP * ref["launches"][name] > 0,
                f"{run}: {name} launched {launches[name]} times, phase 4's tp=1 "
                f"{ref['launches'][name]}")
    require(launches["flash_prefill"] == ref["launches"]["flash_prefill"]
            == cfg.n_layers * len(reqs), f"{run}: flash_prefill launched "
            f"{launches['flash_prefill']} times for {len(reqs)} prefills of {cfg.n_layers} layers")
    require(launches["complete_page"] == TP * cfg.n_layers * em.steps,
            f"{run}: complete_page launched {launches['complete_page']} times in {em.steps} "
            "steps")
    for name in OFF_PATH:
        require(launches[name] == 0, f"{name} launched on the main path ({run})")
    torch.cuda.synchronize()
    page = max(CONT_PROMPTS) // P
    for i, layer in enumerate(eng._pool.state["layers"]):
        for shard in range(TP):
            require(bool(layer[f"{shard}/pool"][:, page].ne(0).any()),
                    f"no page completed during decode ({run}): layer {i} shard {shard}'s pool "
                    f"page {page} is empty in every slot")
    lat = s["latency"]["decode_step_s"]
    gen_tokens = sum(len(o.tokens) for o in outs)
    info = {"run": run, "layers": cfg.n_layers, "devices": [str(d) for d in mesh.devices],
            "decode_steps": em.steps, "decode_ms_per_step": 1e3 * lat["sum"] / lat["count"],
            "tp1_decode_ms_per_step": ref["info"]["decode_ms_per_step"],
            "ttft_s": [o.metrics.ttft_s for o in outs], "tp1_ttft_s": ref["info"]["ttft_s"],
            "tokens_per_s": gen_tokens / wall, "wall_s": wall,
            "host_syncs_per_token": em.host_syncs / gen_tokens,
            "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "recall_overlap": {k: ro[k] for k in ref_ro}, "tp": s["tp"],
            "shard_flight": flight,
            "launches": launches, "tp1_launches": ref["launches"]}
    del eng, outs
    torch.cuda.empty_cache()
    if profile:
        from repro_torch.data.synthetic import needle_stream
        from repro_torch.launch.decode_profile import profile_decode
        stream = needle_stream(cfg.vocab_size, CONTEXT, fkv.page_size, seed=0)
        toks = torch.from_numpy(np.stack([next(stream).tokens for _ in range(B)]))
        prof = profile_decode(cfg, fkv, params, toks.long().to(dev), steps=1,
                              with_prefill=False, mesh=mesh)
        info["profile"] = {k: prof[k] for k in ("wall_ms_per_step_unprofiled",
                                                "cpu_ops_per_step", "device_ops_per_step",
                                                "device_busy_ms_per_step", "device_busy_share")}
        info["tp1_profile"] = {k: ref["info"]["profile"][k] for k in info["profile"]}
        torch.cuda.empty_cache()
    return info, launches


def tp_phase(dev, ops, cfg, params, phase4):
    """Phase 4f: freekv/none at full depth and freekv/int8 at half depth
    (as phase 4's runs of the same method and quantization), both shards on
    cuda:0; with two cards or more, the none case also on cuda:0 and
    cuda:1. Returns (infos, the summed launches)."""
    forms = [("cuda:0", "cuda:0")] + ([("cuda:0", "cuda:1")]
                                      if torch.cuda.device_count() >= 2 else [])
    cases = [(kv_quant, devs) for kv_quant in ("none", "int8") for devs in forms
             if kv_quant == "none" or devs == forms[0]]
    infos, total = [], {}
    for kv_quant, devs in cases:
        t0 = time.perf_counter()
        c, p = (cfg, params) if kv_quant == "none" else half_depth(cfg, params)
        info, launches = tp_run(dev, ops, c, p, kv_quant, devs,
                                phase4[("freekv", kv_quant)],
                                profile=(kv_quant, devs) == ("none", forms[0]))
        info["run_s"] = time.perf_counter() - t0
        infos.append(info)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return infos, total


def tp_paths_vs_plain(dev):
    """Tensor-parallel serving on the card against the CPU: granite-3-8b-
    smoke at float32 (4/2 heads, one KV head a shard) over two shards on
    cuda:0 (and on ("cpu", "cpu")), greedy tokens, steps and counts equal,
    and equal to tp=1's on the CPU: continuous (freekv none and int8, 5
    requests over 2 slots), a preemption, a prefix-cache hit, and the
    static path."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = get_config("granite-3-8b-smoke")
    params_gpu = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    params_cpu = _tree_map(lambda t: t.cpu(), params_gpu)

    def needle(n, seed):
        return next(needle_stream(cfg.vocab_size, n, 8, seed=seed)).tokens

    mixed = [Request(uid=i, tokens=needle(n, 10 + i), max_new_tokens=m)
             for i, (n, m) in enumerate(zip((256, 200, 129, 256, 184), (16, 5, 12, 9, 7)))]
    shared = needle(64, 90)
    cached = [Request(uid=i, tokens=np.concatenate(
        [shared, np.random.default_rng(91 + i).integers(0, cfg.vocab_size, t).astype(np.int32)]),
        max_new_tokens=6) for i, t in enumerate((16, 24, 16))]
    urgent = [Request(uid=i, tokens=needle(n, 95 + i), max_new_tokens=10, priority=int(i == 2))
              for i, n in enumerate((64, 96, 60))]
    cases = [("continuous none", mixed, "none", {}, {}),
             ("continuous int8", mixed, "int8", {}, {}),
             ("preempt", urgent, "none", dict(preempt=True), {}),
             ("prefix-cache hit", cached, "none", {},
              dict(prefix_cache_tokens=4096, prefill_bucket=8)),
             ("static", mixed, "none", {}, dict(scheduler="static"))]
    out = {}
    for name, reqs, kv_quant, fkv_kw, eng_kw in cases:
        fkv = dataclasses.replace(_smoke_fkv("freekv", kv_quant), **fkv_kw)
        got = {}
        for where, tp in (("cuda", TP), ("cpu", TP), ("cpu", 1)):
            on_card = where == "cuda"
            mesh = None if tp == 1 else make_tp_mesh(TP, ("cuda:0" if on_card else "cpu",) * TP)
            eng = ServeEngine(cfg, fkv, params_gpu if on_card else params_cpu, max_len=320,
                              batch_size=2, state_dtype=torch.float32,
                              device=dev if on_card else "cpu", mesh=mesh, **eng_kw)
            toks = [o.tokens for o in eng.generate(reqs)]
            em = eng.last_metrics
            require(eng.last_logits_finite, f"non-finite logits ({where} tp{tp} {name})")
            got[f"{where} tp{tp}"] = (toks, em.steps,
                                      [m.prefix_hit_tokens for m in em.requests],
                                      em.preemptions, em.swap_out_bytes == em.swap_in_bytes)
        first = got[f"cuda tp{TP}"]
        require(all(g == first for g in got.values()), f"tp {name}: {got}")
        toks, steps, hits, pre, _ = first
        if fkv.preempt:
            require(pre >= 1, f"tp {name}: no preemption")
        if "prefix_cache_tokens" in eng_kw:
            require(hits[1:] == [64, 64], f"tp {name}: prefix hits {hits}")
        out[name] = {"steps": steps, "prefix_hit_tokens": hits, "preemptions": pre,
                     "tokens": toks[0][:8]}
    return out


# ---------------------------------------------------------------------------
# phase 4g: serving over a ("data", "model") compute mesh, every shard on
# cuda:0 (ServeEngine(mesh=)): the backbone per data group on its model
# shards, the retrieval state in KV-head groups, page-sharded (the fused
# step) or whole on shard 0. A move between two shards on one card is no
# copy; the bytes that would cross cards are counted (mesh.moved) and put
# over NVLink's data-sheet rate, not timed
# ---------------------------------------------------------------------------
MESH_SMOLLM = "smollm-360m"                # 15/5 heads: the input-dim split
# the kernel forms only the fused step launches; phase 4g's run (b) is their path
MESH_FORMS = ("paged_attention_lse", "select_pages_shard", "complete_page_shard")
MESH_DEEPSEEK_LAYERS = 4                   # the dense prelude layer and 3 MoE periods
MESH_F32_LAYERS = 2                        # the float32 gate's llama31-8b depth
MESH_LOGIT_RTOL = 2e-4                     # of the largest |logit| (tests/test_sharding.py)
MESH_PROFILE_CONTEXT = 2048                # the profiled eager steps' prompts (host ops a step)


def _mesh_expect(kind, m, n_groups, layers, reqs, steps):
    """The launches a phase-4g run implies, by kernel: "groups" (KV-head
    groups, m shards a data group, each its own prefill and decode), "pages"
    (the fused step: the prompt's whole state on shard 0, then m page
    shards a step) and "whole" (the input-dim split: prefill attention over
    query rows split m ways, the retrieval whole on shard 0)."""
    L = layers
    if kind == "groups":
        return {"flash_prefill": m * L * reqs, "fill_pages": m * L * reqs,
                "complete_page": n_groups * m * L * steps,
                "paged_attention": n_groups * m * L * steps,
                "select_pages": n_groups * m * L * steps + m * L * reqs,
                "complete_page_shard": 0, "select_pages_shard": 0, "paged_attention_lse": 0}
    if kind == "pages":
        return {"flash_prefill": m * L * reqs, "fill_pages": L * reqs,
                "select_pages": L * reqs, "recall_gather": L * reqs + m * L * steps,
                "complete_page": 0, "paged_attention": 0,
                "complete_page_shard": m * L * steps, "select_pages_shard": m * L * steps,
                "paged_attention_lse": m * L * steps}
    return {"flash_prefill": m * L * reqs, "fill_pages": L * reqs,
            "complete_page": n_groups * L * steps, "paged_attention": n_groups * L * steps,
            "complete_page_shard": 0, "select_pages_shard": 0, "paged_attention_lse": 0}


def _arch_requests(cfg, fkv, seed=30):
    """Phase 4c's four requests (ARCH_PROMPTS, ARCH_NEW tokens each)."""
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.serving.engine import Request
    return [Request(uid=i, tokens=next(needle_stream(cfg.vocab_size, n, fkv.page_size,
                                                     seed=seed + i)).tokens,
                    max_new_tokens=ARCH_NEW) for i, n in enumerate(ARCH_PROMPTS)]


def mesh_run(dev, ops, label, cfg, params, fkv, dims, reqs, max_len, kind, profile_context):
    """One phase-4g run: ``ServeEngine(mesh=)`` over a ``dims`` mesh of
    shards on ``dev``, continuous over B slots, the launches counted from 0
    just before it; every request finishes with its tokens, the logits are
    finite, each kernel launched as often as the path implies
    (``_mesh_expect``; under the fused step its counter equals the global
    layers x steps). Returns (info, launches, tokens)."""
    from repro_torch.configs.base import ATTN
    from repro_torch.core import retrieval
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.launch.decode_profile import profile_decode
    from repro_torch.configs.base import DENSE
    from repro_torch.models.model import mesh_layout, serving_groups
    from repro_torch.obs import Observability
    from repro_torch.serving.engine import ServeEngine
    layout = mesh_layout(cfg, fkv, (ATTN, DENSE), dims[1], max_len=max_len)
    require(layout == kind, f"{label} {cfg.name} {dims}: the global layers' layout is {layout}, "
            f"the run is meant for {kind}")
    mesh = _mesh(dims, dev)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, fkv, params, max_len=max_len, batch_size=B,
                      state_dtype=torch.bfloat16, obs=Observability(enabled=True), device=dev,
                      mesh=mesh)
    place_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    retrieval.SHARDED_PATHS.update(fused=0, fallback=0)
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    paths = dict(retrieval.SHARDED_PATHS)
    em = eng.last_metrics
    s = em.summary()
    run = f"{label} {cfg.name} {dims[0]}x{dims[1]}"
    require(eng.last_logits_finite, f"non-finite logits ({run})")
    for o, r in zip(outs, reqs):
        require(len(o.tokens) == r.max_new_tokens
                and all(0 <= t < cfg.vocab_size for t in o.tokens),
                f"{run}: request {o.uid} made {len(o.tokens)} tokens or a bad one")
    n_global = sum(mx == ATTN for mx, _ in cfg.layers)
    want = _mesh_expect(kind, dims[1], serving_groups(cfg, mesh, B), n_global, len(reqs),
                        em.steps)
    for name, n in want.items():
        require(launches[name] == n, f"{run}: {name} launched {launches[name]} times, the path "
                f"implies {n} ({em.steps} steps, {len(reqs)} prefills, {n_global} layers)")
    require(launches["recall_gather"] > 0, f"{run}: recall_gather never launched")
    for name in OFF_PATH + ("centroid_candidates", "recall_values", "recall_gather_quant",
                            "recall_values_quant"):
        require(launches[name] == 0, f"{name} launched ({run})")
    if fkv.sharded_retrieval:
        require(paths == {"fused": n_global * em.steps, "fallback": 0},
                f"{run}: the fused step ran {paths} layer-steps, {n_global} x {em.steps} wanted")
    lat = s["latency"]["decode_step_s"]
    gen_tokens = sum(len(o.tokens) for o in outs)
    ms = s["mesh"]
    info = {"run": label, "arch": cfg.name, "layers": cfg.n_layers, "mesh": list(dims),
            "layout": kind, "sharded_retrieval": fkv.sharded_retrieval,
            "sharded_overselect": fkv.sharded_overselect, "pool_pad_pages": fkv.pool_pad_pages,
            "requests": len(reqs), "decode_steps": em.steps,
            "decode_ms_per_step": 1e3 * lat["sum"] / lat["count"],
            "ttft_s": [o.metrics.ttft_s for o in outs], "tokens_per_s": gen_tokens / wall,
            "wall_s": wall, "place_params_s": place_s,
            "host_syncs_per_token": em.host_syncs / gen_tokens,
            "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "moved_bytes_per_step": ms["bytes_per_step"],
            "moved_bytes_per_step_total": ms["bytes_per_step_total"],
            "nvlink_ms_per_step_computed": ms["nvlink_ms_per_step"],
            "moved_prefill_bytes": ms["prefill_bytes"], "fused_paths": paths,
            "launches": {k: v for k, v in launches.items() if v},
            "first_tokens": outs[0].tokens[:8]}
    tokens = {o.uid: o.tokens for o in outs}
    placed = eng.params
    del eng, outs
    torch.cuda.empty_cache()
    stream = needle_stream(cfg.vocab_size, profile_context, fkv.page_size, seed=0)
    toks = torch.from_numpy(np.stack([next(stream).tokens for _ in range(B)]))
    prof = profile_decode(cfg, fkv, placed, toks.long().to(dev), steps=1, with_prefill=False,
                          mesh=mesh)
    info["profile"] = {k: prof[k] for k in ("wall_ms_per_step_unprofiled", "cpu_ops_per_step",
                                            "device_ops_per_step", "device_busy_share")}
    del placed
    torch.cuda.empty_cache()
    return info, launches, tokens


def _greedy_logits(cfg, fkv, params, toks, max_len, steps, mesh, state_dtype=torch.float32):
    """prefill, then ``steps`` greedy serve_steps: the logits of each
    (steps + 1, B, V) on the primary device, each run fed its own tokens.
    ``toks`` the prompt tokens, or a batch dict (with a frontend's frames)."""
    from repro_torch.models.model import prefill, serve_step
    batch = toks if isinstance(toks, dict) else {"tokens": toks}
    logits, st = prefill(cfg, fkv, params, batch, max_len, state_dtype=state_dtype, mesh=mesh)
    rows = [logits]
    for _ in range(steps):
        logits, st = serve_step(cfg, fkv, params, st, logits.argmax(-1)[:, None], mesh=mesh)
        rows.append(logits)
    return torch.stack(rows)


def mesh_f32_gate(dev, ops):
    """llama31-8b cut to MESH_F32_LAYERS at full width, float32, on phase
    4c's prompts (left-padded into one batch of B) and ARCH_NEW greedy
    steps, at (2, 2) against no mesh: prefill and every step's logits within
    MESH_LOGIT_RTOL of the largest |logit| and the same greedy tokens. A
    request whose token flips at a near tie (its top-2 margin printed)
    leaves the comparison from that step on: the two runs no longer decode
    the same sequence."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.models.model import init_params
    from repro_torch.sharding import rules
    t0 = time.perf_counter()
    full = get_config("llama31-8b")
    cfg = dataclasses.replace(full, n_layers=MESH_F32_LAYERS, n_periods=MESH_F32_LAYERS)
    params = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    fkv = FreeKVConfig(method="freekv", offload="host")
    T = max(ARCH_PROMPTS)
    toks = torch.zeros((B, T), dtype=torch.long)
    for i, n in enumerate(ARCH_PROMPTS):
        toks[i, T - n:] = torch.from_numpy(next(needle_stream(
            cfg.vocab_size, n, fkv.page_size, seed=30 + i)).tokens).long()
    toks = toks.to(dev)
    max_len = T + ARCH_NEW + P
    plain = _greedy_logits(cfg, fkv, params, toks, max_len, ARCH_NEW, None)
    mesh = _mesh((2, 2), dev)
    placed = rules.place_serving_params(cfg, params, mesh)
    meshed = _greedy_logits(cfg, fkv, placed, toks, max_len, ARCH_NEW, mesh)
    del placed, params
    worst, flips, live = _hold_logits(cfg, plain, meshed, MESH_LOGIT_RTOL, "f32 gate")
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers, "dtype": "float32", "mesh": [2, 2],
            "steps": ARCH_NEW, "max_rel_logit_err": worst, "rtol": MESH_LOGIT_RTOL,
            "flips": flips, "requests_compared_to_the_end": live,
            "s": time.perf_counter() - t0}


def _hold_logits(cfg, plain, meshed, rtol, what):
    """Two ``_greedy_logits`` runs over the real vocabulary (the padding's
    logits are the dtype's min in both): each step's logits within ``rtol``
    of the largest |logit| (None: reported, not gated). A request whose
    token flips at a near tie (its top-2 margin logged) leaves the
    comparison from that step on: the two runs no longer decode the same
    sequence. Returns (the largest error over the largest |logit|, the
    flips, the requests compared to the end)."""
    plain, meshed = plain[..., :cfg.vocab_size].float(), meshed[..., :cfg.vocab_size].float()
    live = torch.ones(plain.shape[1], dtype=torch.bool, device=plain.device)
    worst, flips = 0.0, []
    for step in range(plain.shape[0]):
        a, b = plain[step], meshed[step]
        scale = a[live].abs().max().item() if bool(live.any()) else 1.0
        err = (a - b).abs().amax(dim=-1)
        bad = live & (err > rtol * scale) if rtol is not None else live & False
        require(not bool(bad.any()), f"{what} step {step}: logits of rows "
                f"{bad.nonzero().flatten().tolist()} differ by {err[bad].tolist()}, over "
                f"{rtol} x {scale}")
        if bool(live.any()):
            worst = max(worst, (err[live] / scale).max().item())
        flip = live & (a.argmax(-1) != b.argmax(-1))
        for r in flip.nonzero().flatten().tolist():
            top2 = a[r].topk(2).values
            margin = (top2[0] - top2[1]).item()
            flips.append({"request": r, "step": step, "top2_margin": margin})
            log(f"[mesh] {what}: request {r}'s token flips at step {step} at a top-2 margin "
                f"of {margin:.3g} (largest |logit| {scale:.3g}); it leaves the comparison")
        live &= ~flip
    return worst, flips, int(live.sum())


def mesh_bit_gate(dev, ops):
    """smollm-360m at full width (bf16) on phase 4c's traffic: a 1 x 1 mesh
    gives no mesh's tokens and launch counts, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServeEngine
    t0 = time.perf_counter()
    cfg = get_config(MESH_SMOLLM)
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    fkv = FreeKVConfig(method="freekv", offload="host")
    out = {}
    for dims in (None, (1, 1)):
        mesh = None if dims is None else _mesh(dims, dev)
        eng = ServeEngine(cfg, fkv, params, max_len=max(ARCH_PROMPTS) + ARCH_NEW + P,
                          batch_size=B, state_dtype=torch.bfloat16, device=dev, mesh=mesh)
        ops.reset_launches()
        outs = eng.generate(_arch_requests(cfg, fkv))
        out[dims] = ({o.uid: o.tokens for o in outs},
                     {fn.__name__: fn.launches for fn in ops.KERNELS})
        del eng, outs
    require(out[None] == out[(1, 1)], f"1 x 1 mesh gate: tokens or launches differ from no "
            f"mesh: {out[None]} vs {out[(1, 1)]}")
    del params
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "tokens_equal": True, "launches_equal": True,
            "launches": {k: v for k, v in out[None][1].items() if v},
            "s": time.perf_counter() - t0}


MESH_FUSED_STEPS = 8                       # the card-vs-CPU gate's decode steps
MESH_FUSED_T = CONTEXT - 3                 # its prompt: a page completes at step 3


def _fused_retriever_run(cfg, fkv, x, device):
    """``PageShardedRetriever`` over a (1, MESH_SHARDS) mesh of shards on
    ``device``: prefill, then MESH_FUSED_STEPS decode steps on ``x``'s
    inputs -> (outputs, infos, per-step ids, the final state), on the CPU."""
    from repro_torch.core.sharded_retrieval import PageShardedRetriever
    from repro_torch.sharding.transfer import MeshRow
    mesh = _mesh((1, MESH_SHARDS), device)
    r = PageShardedRetriever(cfg, fkv, MeshRow(mesh, 0))
    dev = mesh.primary
    st = r.init_state(B, MAX_LEN, torch.bfloat16)
    st = r.prefill(st, x["k"].to(dev), x["v"].to(dev), x["q_last"].to(dev))
    outs, infos, ids = [], [], []
    for t in range(MESH_FUSED_STEPS):
        o, st, info = r.decode(st, x["q"][t].to(dev), x["kn"][t].to(dev), x["vn"][t].to(dev))
        outs.append(o.float().cpu())
        infos.append({k: v.cpu() for k, v in info.items() if isinstance(v, torch.Tensor)})
        ids.append([st[f"{j}/sel_idx"].cpu() for j in range(MESH_SHARDS)])
    state = {k: v.cpu() for k, v in st.items()}
    return outs, infos, ids, state


def mesh_fused_gate(dev, ops):
    """The fused step as ``PageShardedRetriever`` runs it (ring append,
    the owner's page completion, local selection with global ids, the
    overselect re-rank, local recall, the speculative reuse, the page
    region's masking and the log-sum-exp merge), llama31-8b's per-layer
    shapes (B 4, a MESH_FUSED_T-token prompt, overselect 2, pool_pad_pages
    4) on MESH_SHARDS page shards on the card against the same shards on
    the CPU (the plain versions), on the same seeded bf16 inputs: every
    step's ids, corrected heads and counters exactly equal, its output
    within TOL and the heads' similarity within TOL's fp32 entry; the final
    pool, summaries and rings exactly equal. Every
    other step's query is the last one plus a little noise, so the
    uncorrected heads reuse their previous selection."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    t0 = time.perf_counter()
    cfg = get_config("llama31-8b")
    fkv = FreeKVConfig(method="freekv", offload="host", sharded_retrieval=True,
                       sharded_overselect=2, pool_pad_pages=4)
    rng = np.random.default_rng(7)
    kv, d, H = cfg.n_kv_heads, cfg.d_head, cfg.n_heads

    def n(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)
    x = {"k": n(B, MESH_FUSED_T, kv, d), "v": n(B, MESH_FUSED_T, kv, d), "q_last": n(B, H, d),
         "kn": n(MESH_FUSED_STEPS, B, kv, d), "vn": n(MESH_FUSED_STEPS, B, kv, d)}
    qs = [n(B, H, d)]
    for t in range(1, MESH_FUSED_STEPS):
        qs.append(n(B, H, d) if t % 2 == 0 else (qs[-1].float() + 0.05 * n(B, H, d).float())
                  .to(torch.bfloat16))
    x["q"] = torch.stack(qs)
    card = _fused_retriever_run(cfg, fkv, x, dev)
    cpu = _fused_retriever_run(cfg, fkv, x, "cpu")
    worst, corrected = 0.0, []
    for t in range(MESH_FUSED_STEPS):
        got, want = card[0][t], cpu[0][t]
        err = (got - want).abs().max().item()
        require(torch.allclose(got, want, **TOL[torch.bfloat16]),
                f"fused gate step {t}: output max |err| {err} card vs CPU, tolerance "
                f"{TOL[torch.bfloat16]}")
        worst = max(worst, err)
        for k, v in cpu[1][t].items():
            # the query's cosine similarity is a float32 reduction: TOL's
            # fp32 entry; the corrected heads and the counters exact
            same = (torch.allclose(card[1][t][k], v, **TOL[torch.float32])
                    if v.is_floating_point() else torch.equal(card[1][t][k], v))
            require(same, f"fused gate step {t}: info {k} differs")
        for j in range(MESH_SHARDS):
            require(torch.equal(card[2][t][j], cpu[2][t][j]),
                    f"fused gate step {t}: shard {j}'s selected ids differ")
        corrected.append(int(cpu[1][t]["corrected"].sum()))
    for k, v in cpu[3].items():
        require(torch.equal(card[3][k], v), f"fused gate: final state leaf {k} differs")
    require(min(corrected) < B * kv,
            f"fused gate: every step corrected {corrected} of {B * kv} heads; the reuse path "
            "never ran")
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "mesh": [1, MESH_SHARDS], "batch": B, "prompt": MESH_FUSED_T,
            "steps": MESH_FUSED_STEPS, "sharded_overselect": 2,
            "output_max_abs_err_card_vs_cpu": worst, "tol": TOL[torch.bfloat16],
            "ids_equal": True, "state_equal": True, "corrected_heads_per_step": corrected,
            "s": time.perf_counter() - t0}


# phase 4g (e)-(g): the recurrent mixers and the encoder-decoder under a mesh,
# (label, arch, mesh, the four requests' prompt tokens, whether its float32
# logit gate runs at ``mixer_cut``'s depth). xlstm-350m's prompts stay at one
# sLSTM scan chunk (its prefill is a Python loop over time). jamba's smoke
# width serves (the full model is ~398 B parameters)
MESH_X_NEW = 8
MESH_X_RUNS = (("(e)", "xlstm-350m", (1, 2), (256, 256, 256, 256), True),
               ("(f)", "whisper-tiny", (1, 2), (3072, 2560, 2048, 2816), False),
               ("(g)", "jamba-1.5-large-398b-smoke", (2, 2), (512, 448, 384, 480), False))


def mixer_cut(cfg):
    """xlstm-350m cut to one mLSTM and one sLSTM layer at full width, for
    its float32 gates (4g (e), 6c): with seeded weights its runs of five
    mLSTM layers amplify float rounding, with no mesh as with one, so that
    two summation orders of the whole period land at about the gate's 2e-4
    of the largest |logit|; the cut still runs both mixers' mesh forms."""
    return dataclasses.replace(cfg, n_layers=2, n_periods=1,
                               pattern=(("mlstm", "none"), ("slstm", "none")))
MESH_SPEC_DRAFT = 4                        # (h)'s draft_len


def _xmesh_expect(cfg, m, n_groups, reqs, steps):
    """The launches a phase-4g (e)-(g) run implies: its decoder attention
    layers' KV-head groups (``_mesh_expect``) and each encoder layer's
    bidirectional flash_prefill on each of the m shards an admission."""
    from repro_torch.configs.base import ATTN
    n_attn = sum(mx == ATTN for mx, _ in cfg.layers)
    if not n_attn:
        return {fn: 0 for fn in _mesh_expect("groups", m, n_groups, 1, reqs, steps)}
    want = _mesh_expect("groups", m, n_groups, n_attn, reqs, steps)
    if cfg.is_encoder_decoder:
        want["flash_prefill"] += cfg.n_encoder_layers * m * reqs
    return want


def xmesh_run(dev, ops, label, arch, dims, prompts, gate_cut=False):
    """One phase-4g run of a recurrent or encoder-decoder arch at full
    width and depth (seeded bf16 weights, freekv, the pinned pool, 4 slots,
    4 needle requests x MESH_X_NEW greedy tokens with seeded frontends):
    ``ServeEngine`` with no mesh, on a 1 x 1 mesh and on ``dims`` (every
    shard on ``dev``), the launches counted from 0 just before each. The
    1 x 1 mesh gives no mesh's tokens and launches bit for bit; the
    ``dims`` run launches what its layout implies (``_xmesh_expect``);
    its tokens beside no mesh's, reported. Then request 0 alone, greedy
    from its prefill, the stack cut by ``mixer_cut`` under ``gate_cut``: in
    float32 every step's logits within MESH_LOGIT_RTOL of the largest
    |logit| of no mesh's (gated), in bf16 the flips and their margins
    (reported). Returns (info, the dims run's launches)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.data.synthetic import needle_stream
    from repro_torch.models.model import init_params, recurrent_shards, serving_groups
    from repro_torch.obs import Observability
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.sharding import rules
    t_run = time.perf_counter()
    cfg = get_config(arch)
    fkv = FreeKVConfig(method="freekv", offload="host")
    rng = np.random.default_rng(43)
    reqs = [Request(uid=i, tokens=next(needle_stream(cfg.vocab_size, n, fkv.page_size,
                                                     seed=30 + i)).tokens,
                    max_new_tokens=MESH_X_NEW, frontend=_frontend(cfg, rng))
            for i, n in enumerate(prompts)]
    max_len = max(prompts) + MESH_X_NEW + P
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    runs = {}
    for dm in (None, (1, 1), dims):
        mesh = None if dm is None else _mesh(dm, dev)
        eng = ServeEngine(cfg, fkv, params, max_len=max_len, batch_size=B,
                          state_dtype=torch.bfloat16, obs=Observability(enabled=True),
                          device=dev, mesh=mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        outs = eng.generate(reqs)
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
        em = eng.last_metrics
        s = em.summary()
        run = f"{label} {arch} {dm}"
        require(eng.last_logits_finite, f"non-finite logits ({run})")
        for o, r in zip(outs, reqs):
            require(len(o.tokens) == r.max_new_tokens
                    and all(0 <= t < cfg.vocab_size for t in o.tokens),
                    f"{run}: request {o.uid} made {len(o.tokens)} tokens or a bad one")
        lat = s["latency"]["decode_step_s"]
        gen_tokens = sum(len(o.tokens) for o in outs)
        info = {"decode_ms_per_step": 1e3 * lat["sum"] / lat["count"],
                "decode_steps": em.steps, "ttft_s": [o.metrics.ttft_s for o in outs],
                "tokens_per_s": gen_tokens / wall, "wall_s": wall,
                "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
        if dm is not None:
            ms = s["mesh"]
            info.update(moved_bytes_per_step=ms["bytes_per_step"],
                        nvlink_ms_per_step_computed=ms["nvlink_ms_per_step"],
                        moved_prefill_bytes=ms["prefill_bytes"])
        runs[dm] = ({o.uid: o.tokens for o in outs}, launches, info, em.steps)
        del eng, outs
        torch.cuda.empty_cache()
    require(runs[None][:2] == runs[(1, 1)][:2], f"{label} {arch}: a 1 x 1 mesh's tokens or "
            f"launches differ from no mesh's: {runs[None][:2]} vs {runs[(1, 1)][:2]}")
    toks, launches, info, steps = runs[dims]
    mesh = _mesh(dims, dev)
    want = _xmesh_expect(cfg, dims[1], serving_groups(cfg, mesh, B), len(reqs), steps)
    for name, n in want.items():
        require(launches[name] == n, f"{label} {arch} {dims}: {name} launched "
                f"{launches[name]} times, the path implies {n}")
    require(all(launches[n] == 0 for n in OFF_PATH), f"{label} {arch}: an off-path kernel "
            f"launched: {launches}")
    plain = runs[None][0]
    info["first_differing_token_vs_no_mesh"] = {
        uid: next((i for i, (x, y) in enumerate(zip(t, plain[uid])) if x != y), None)
        for uid, t in toks.items()}
    # request 0 alone, greedy: float32 gated, bf16 reported
    one = {"tokens": torch.from_numpy(reqs[0].tokens[None]).long().to(dev)}
    if reqs[0].frontend is not None:
        one["frontend"] = torch.from_numpy(reqs[0].frontend[None]).to(dev)
    logit_gates = {}
    del params
    gcfg = mixer_cut(cfg) if gate_cut else cfg
    for dt, rtol in ((torch.float32, MESH_LOGIT_RTOL), (torch.bfloat16, None)):
        p = init_params(gcfg, seed=0, device=dev, dtype=dt)
        a = _greedy_logits(gcfg, fkv, p, one, max_len, MESH_X_NEW, None, state_dtype=dt)
        placed = rules.place_serving_params(gcfg, p, mesh)
        b = _greedy_logits(gcfg, fkv, placed, one, max_len, MESH_X_NEW, mesh, state_dtype=dt)
        worst, flips, _ = _hold_logits(gcfg, a, b, rtol, f"{label} {arch} {str(dt)[6:]}")
        logit_gates[str(dt)[6:]] = {"max_rel_logit_err": worst, "rtol": rtol, "flips": flips}
        del p, placed, a, b
        torch.cuda.empty_cache()
    info.update(run=label, arch=arch, layers=cfg.n_layers, mesh=list(dims),
                prompt_tokens=list(prompts), no_mesh=runs[None][2],
                bit_1x1={"tokens_equal": True, "launches_equal": True},
                logit_gates=logit_gates, logit_gate_layers=gcfg.n_layers,
                state_shards={mx: recurrent_shards(cfg, mx, dims[1])
                              for mx in {m_ for m_, _ in cfg.layers} if mx != "attn"},
                launches={k: v for k, v in launches.items() if v},
                run_s=time.perf_counter() - t_run)
    torch.cuda.empty_cache()
    return info, launches


def mesh_spec_run(dev, ops, cfg, params, dims, base_reqs, base_tokens, steps0):
    """Phase 4g (h): ``base_reqs`` again through ``ServeEngine(mesh=dims,
    draft_len=MESH_SPEC_DRAFT)``, each request's ``draft_hint`` its prompt's
    last token and run (c)'s output: the engine speculates, every token
    equals run (c)'s draft_len 0 tokens (``base_tokens``), launches counted
    from 0 just before it. Returns (info, launches)."""
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.serving.engine import Request, ServeEngine
    t_run = time.perf_counter()
    fkv = FreeKVConfig(method="freekv", offload="host", draft_len=MESH_SPEC_DRAFT)
    reqs = [Request(uid=r.uid, tokens=r.tokens, max_new_tokens=r.max_new_tokens,
                    draft_hint=np.concatenate([r.tokens[-1:],
                                               np.asarray(base_tokens[r.uid], np.int32)]))
            for r in base_reqs]
    mesh = _mesh(dims, dev)
    eng = ServeEngine(cfg, fkv, params, max_len=max(len(r.tokens) for r in reqs) + ARCH_NEW + P,
                      batch_size=B, state_dtype=torch.bfloat16, device=dev, mesh=mesh)
    require(eng.spec_decode, f"(h) {cfg.name} {dims}: speculative decoding fell back")
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    em = eng.last_metrics
    sd = em.summary()["specdec"]
    require(eng.last_logits_finite, f"non-finite logits ((h) {cfg.name})")
    toks = {o.uid: o.tokens for o in outs}
    require(toks == base_tokens, f"(h) {cfg.name} {dims} draft_len {MESH_SPEC_DRAFT}: tokens "
            f"{toks} differ from run (c)'s draft_len 0 tokens {base_tokens}")
    require(launches["paged_attention"] > 0 and launches["recall_gather"] > 0,
            f"(h): the retrieval kernels never launched: {launches}")
    gen_tokens = sum(len(o.tokens) for o in outs)
    committed = gen_tokens - len(outs)          # the first tokens come from the prefills
    decode_s = wall - sum(o.prefill_s for o in outs)
    info = {"run": "(h)", "arch": cfg.name, "layers": cfg.n_layers, "mesh": list(dims),
            "draft_len": MESH_SPEC_DRAFT, "hinted": True, "tokens_equal_run_c": True,
            "accept_rate": sd["accept_rate"], "tokens_per_target_step": sd["tokens_per_step"],
            "verify_steps": sd["verify_steps"], "idle_iterations": sd["idle_iterations"],
            "decode_ms_per_committed_token": 1e3 * decode_s / committed,
            "run_c_decode_steps": steps0, "wall_s": wall,
            "moved_bytes_per_step": em.summary()["mesh"]["bytes_per_step"],
            "launches": {k: v for k, v in launches.items() if v},
            "run_s": time.perf_counter() - t_run}
    del eng, outs
    torch.cuda.empty_cache()
    return info, launches


def mesh_phase(dev, ops, cfg, params, phase4):
    """Phase 4g: (a) llama31-8b at full width and depth on a (2, 2) mesh,
    freekv/none on phase 4's traffic (KV-head groups: 8 KV heads over 2);
    (b) llama31-8b at half depth on (1, 4) with the fused step
    (sharded_retrieval, sharded_overselect 2, pool_pad_pages 4); (c)
    smollm-360m on (1, 2) (15/5 heads: the input-dim split, the state whole
    on shard 0), phase 4c's traffic; (h) smollm-360m on (1, 2) with
    speculative decoding (``mesh_spec_run``), its tokens (c)'s; (d)
    deepseek-moe-16b cut to MESH_DEEPSEEK_LAYERS on (1, 4)
    (expert-parallel), phase 4c's traffic; (e)-(g) the recurrent and
    encoder-decoder archs (``xmesh_run``, ``MESH_X_RUNS``); then the 1 x 1
    bit gate, the float32 gate and the fused step's card against CPU gate
    (``mesh_fused_gate``). (a)'s tokens and prefill logits beside phase 4's
    no-mesh run, printed, not gated. Returns (infos, gates, the summed
    launches)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FreeKVConfig
    from repro_torch.models.model import init_params, prefill
    from repro_torch.sharding import rules
    infos, total = [], {}

    def add(launches):
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n

    fkv = FreeKVConfig(method="freekv", offload="host")
    reqs = main_requests(cfg, fkv)
    t0 = time.perf_counter()
    info, launches, toks = mesh_run(dev, ops, "(a)", cfg, params, fkv, (2, 2), reqs, MAX_LEN,
                                    "groups", MESH_PROFILE_CONTEXT)
    ref = phase4[("freekv", "none")]["tokens"]
    info["first_differing_token_vs_no_mesh"] = {
        uid: next((i for i, (x, y) in enumerate(zip(t, ref[uid])) if x != y), None)
        for uid, t in toks.items()}
    one = torch.from_numpy(reqs[0].tokens[None]).long().to(dev)
    lp = prefill(cfg, fkv, params, {"tokens": one}, MAX_LEN, state_dtype=torch.bfloat16)[0]
    mesh = _mesh((2, 2), dev)
    placed = rules.place_serving_params(cfg, params, mesh)
    lm = prefill(cfg, fkv, placed, {"tokens": one}, MAX_LEN, state_dtype=torch.bfloat16,
                 mesh=mesh)[0]
    del placed
    # over the real vocabulary: the padding's logits are the dtype's min
    lp, lm = lp[:, :cfg.vocab_size].float(), lm[:, :cfg.vocab_size].float()
    info["bf16_prefill_logits_rel_max_err_vs_no_mesh"] = (
        (lp - lm).abs().max() / lp.abs().max()).item()
    torch.cuda.empty_cache()
    info["run_s"] = time.perf_counter() - t0
    infos.append(info)
    add(launches)

    # (b) at half depth: at full depth phase 4g took 228.8 s of its 200
    # (NVIDIA H100 80GB HBM3, 700 W), the script 1119.9 s of its 1200
    t0 = time.perf_counter()
    half, half_params = half_depth(cfg, params)
    fused = FreeKVConfig(method="freekv", offload="host", sharded_retrieval=True,
                         sharded_overselect=2, pool_pad_pages=4)
    info, launches, _ = mesh_run(dev, ops, "(b)", half, half_params, fused, (1, 4), reqs,
                                 MAX_LEN, "pages", MESH_PROFILE_CONTEXT)
    info["run_s"] = time.perf_counter() - t0
    infos.append(info)
    add(launches)
    del half_params

    t0 = time.perf_counter()
    smol = get_config(MESH_SMOLLM)
    sp = init_params(smol, seed=0, device=dev, dtype=torch.bfloat16)
    smol_reqs = _arch_requests(smol, fkv)
    info, launches, smol_toks = mesh_run(dev, ops, "(c)", smol, sp, fkv, (1, 2), smol_reqs,
                                         max(ARCH_PROMPTS) + ARCH_NEW + P, "whole",
                                         MESH_PROFILE_CONTEXT)
    info["run_s"] = time.perf_counter() - t0
    infos.append(info)
    add(launches)
    info, launches = mesh_spec_run(dev, ops, smol, sp, (1, 2), smol_reqs, smol_toks,
                                   info["decode_steps"])
    infos.append(info)
    add(launches)
    del sp

    t0 = time.perf_counter()
    full = get_config("deepseek-moe-16b")
    ds = dataclasses.replace(full, n_layers=MESH_DEEPSEEK_LAYERS,
                             n_periods=MESH_DEEPSEEK_LAYERS - len(full.prelude))
    dp = init_params(ds, seed=0, device=dev, dtype=torch.bfloat16)
    info, launches, _ = mesh_run(dev, ops, "(d)", ds, dp, fkv, (1, 4), _arch_requests(ds, fkv),
                                 max(ARCH_PROMPTS) + ARCH_NEW + P, "groups",
                                 MESH_PROFILE_CONTEXT)
    info["run_s"] = time.perf_counter() - t0
    infos.append(info)
    add(launches)
    del dp
    torch.cuda.empty_cache()
    for label, arch, dims, prompts, gate_cut in MESH_X_RUNS:
        info, launches = xmesh_run(dev, ops, label, arch, dims, prompts, gate_cut)
        infos.append(info)
        add(launches)
    gates = {"bit_1x1": mesh_bit_gate(dev, ops), "f32_2x2": mesh_f32_gate(dev, ops),
             "fused_card_vs_cpu": mesh_fused_gate(dev, ops)}
    return infos, gates, total


# ---------------------------------------------------------------------------
# phase 6: training. smollm-360m at full width (float32, B 4, T 4096: the
# reference's train_4k length, past the dense attention's 2048 x 2048, so
# the chunked attention with its per-chunk checkpoints), 6 AdamW steps with
# the launcher's defaults; a checkpoint round trip; the trained weights
# served; model-parallel training at full width on meshes of shards on one
# card; then every smoke arch's steps and served tokens card == CPU, and
# four smoke archs' steps on (2, 2) and (1, 4) meshes card == CPU
# ---------------------------------------------------------------------------
TRAIN_ARCH = "smollm-360m"
TRAIN_B, TRAIN_T, TRAIN_STEPS = 4, 4096, 4
TRAIN_SMOKE = ("smollm-360m-smoke", "gemma2-2b-smoke", "deepseek-moe-16b-smoke",
               "jamba-1.5-large-398b-smoke", "xlstm-350m-smoke", "whisper-tiny-smoke",
               "internvl2-26b-smoke", "llama4-scout-17b-a16e-smoke")
TRAIN_SMOKE_B, TRAIN_SMOKE_T, TRAIN_SMOKE_STEPS = 2, 128, 3
TRAIN_LOSS_RTOL = 1e-4
# phase 6c: (arch, mesh(es) (data, model), B, T)
MP_STEPS = 2
MP_SMOLLM = (TRAIN_ARCH, (1, 2), TRAIN_B, TRAIN_T)
MP_DEEPSEEK = ("deepseek-moe-16b", ((1, 1), (1, 4)), 2, 2048)
MP_DEEPSEEK_LAYERS = 4          # the dense prelude layer and 3 MoE periods
# the recurrent and encoder-decoder archs at full width, (arch, B, T, whether
# cut by ``mixer_cut``, as phase 4g (e)'s gate, the leading steps whose
# losses are held) at (1, 1) and (1, 2): those losses within MP_X_RTOL of
# each other, and the first batch's gradients leaf by leaf within
# MP_GRAD_RTOL relative L2 (the CPU tests' tolerance against the
# reference). xlstm-350m holds its first step's loss: AdamW's first update
# is lr times the gradient's sign, so the elements whose gradient rounds to
# either side of 0 in the two summation orders step apart (its second
# step's loss move is logged)
MP_XARCH = (("xlstm-350m", 2, 256, True, 1), ("whisper-tiny", 2, 448, False, 2))
MP_GRAD_RTOL, MP_GRAD_ATOL = 1e-4, 1e-6
MP_X_RTOL = 2e-5
# phase 6d's meshes for the smoke archs, card == CPU
MP_SMOKE = ("deepseek-moe-16b-smoke", "llama4-scout-17b-a16e-smoke", "smollm-360m-smoke",
            "gemma2-2b-smoke")
MP_SMOKE_MESHES = ((2, 2), (1, 4))


def _train_opt(steps):
    from repro_torch.training.optimizer import AdamWConfig
    # the launcher's AdamW: lr 1e-3, warmup steps // 10, a cosine over the run
    return AdamWConfig(lr=1e-3, warmup_steps=max(steps // 10, 1), total_steps=steps)


def train_step_flops(cfg, n_params, B, T):
    """Float32 operations of one remat train step: 8 N a token for the
    dense products (forward 2N, backward 4N, the period's recomputed
    forward 2N; N counts the tied embedding once, as the LM head's
    product), plus 4 times the attention's forward (forward, recompute and
    a backward of twice the forward): q k^T and p v, 2 * 2 * B * H * T^2 *
    d_head a layer, every query-key pair, which the chunked path computes
    masked or not."""
    attn_fwd = 4 * B * cfg.n_heads * T * T * cfg.d_head * cfg.n_layers
    return 8 * n_params * B * T + 4 * attn_fwd


def profile_train_grad(cfg, params, batch, top=10):
    """Where a train step's time goes: one forward_train + backward (no
    update, so the params do not move) under torch.profiler. Returns the
    wall ms, the card's busy ms (its kernel and copy rows,
    ``decode_profile.device_rows``) and share, and the ``top`` rows by
    device ms; None for the device numbers where the profiler recorded no
    device event."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.decode_profile import dev_us, device_rows
    from repro_torch.models.model import forward_train
    from repro_torch.training.optimizer import tree_leaves
    leaves = [p for _, p in tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, _ = forward_train(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    for p in leaves:
        p.requires_grad_(False)
    del grads, loss
    rows = device_rows(prof.key_averages())
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    if not rows:
        return {"wall_ms": wall_ms, "device_ms": None, "busy_share": None, "top": None}
    rows.sort(key=dev_us, reverse=True)
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "top": [{"kernel": e.key[:90], "ms": dev_us(e) / 1e3, "count": e.count,
                     "share": dev_us(e) / 1e3 / busy_ms} for e in rows[:top]]}


def train_full_width(dev, ops):
    """Phase 6a and 6b: smollm-360m trained at full width, its state saved
    and restored bit for bit, its trained weights (bf16) served through the
    continuous engine (``wide_run``: freekv/none, 4 needle requests x 16
    tokens over 4 slots). Returns (info, the serve's launches)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train_step import init_train, make_train_step

    cfg = get_config(TRAIN_ARCH)
    opt_cfg = _train_opt(TRAIN_STEPS)
    torch.cuda.empty_cache()
    # what earlier phases leave allocated counts in the peak too
    resident = torch.cuda.memory_allocated(dev)
    params, opt = init_train(cfg, opt_cfg, seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)       # the state's bytes stay in the peak
    n_params = sum(p.numel() for _, p in tree_leaves(params))
    step = make_train_step(cfg, opt_cfg)
    data = lm_batches(cfg.vocab_size, TRAIN_T, TRAIN_B, seed=0)
    flops = train_step_flops(cfg, n_params, TRAIN_B, TRAIN_T)
    bound_s = flops / rl.PEAK_F32
    ops.reset_launches()
    rows = []
    for i in range(TRAIN_STEPS):
        tokens = torch.from_numpy(next(data)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, {"tokens": tokens})
        loss, gnorm, lr = float(m["loss"]), float(m["grad_norm"]), float(m["lr"])
        dt = time.perf_counter() - t0
        require(math.isfinite(loss) and math.isfinite(gnorm),
                f"{TRAIN_ARCH} step {i}: loss {loss}, grad norm {gnorm}")
        rows.append({"step": i, "loss": loss, "grad_norm": gnorm, "lr": lr, "s": dt})
        log(f"[train] {TRAIN_ARCH} step {i}: loss {loss:.4f} grad norm {gnorm:.4f} lr {lr:.2e} "
            f"{dt:.3f} s")
    launched = {fn.__name__: fn.launches for fn in ops.KERNELS}
    require(not any(launched.values()),
            f"the train step launched a serving kernel: {launched}")
    prof = profile_train_grad(cfg, params, {"tokens": tokens})
    s_step = sum(r["s"] for r in rows[1:]) / (TRAIN_STEPS - 1)
    info = {"arch": TRAIN_ARCH, "dtype": "float32", "batch": TRAIN_B, "seq": TRAIN_T,
            "params": n_params, "steps": rows,
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "s_per_step_after_first": s_step, "tokens_per_s": TRAIN_B * TRAIN_T / s_step,
            "flops_per_step": flops, "bound_s_float32": bound_s,
            "bound_share": bound_s / s_step,
            "achieved_tflops": flops / s_step / 1e12,
            "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "resident_before_gib": resident / 2 ** 30,
            "profile_forward_backward": prof}

    # 6b: the checkpoint round trip, written inside the checkout (build/ is
    # ignored) and removed after
    ck = Path(__file__).resolve().parent / "build" / "train_ckpt" / f"{TRAIN_ARCH}.npz"
    state = {"params": params, "opt": opt}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(str(ck), cfg, state)
    save_s = time.perf_counter() - t0
    size = ck.stat().st_size
    t0 = time.perf_counter()
    back = checkpoint.restore(str(ck), cfg, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    ck.unlink()
    want = dict(tree_leaves(state))
    got = tree_leaves(back)
    require(len(got) == len(want), "the restored state has other leaves")
    for path, t in got:
        require(t.dtype == want[path].dtype and t.device == want[path].device
                and torch.equal(t, want[path]), f"checkpoint leaf {path} differs")
    info["checkpoint"] = {"bytes": size, "leaves": len(got), "save_s": save_s,
                          "restore_s": restore_s, "round_trip_s": save_s + restore_s,
                          "bit_equal": True}
    del back, state, opt, step
    served = tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    torch.cuda.empty_cache()
    serve, launches = wide_run(dev, ops, cfg, served, "freekv", 0.0)
    info["serve"] = {k: serve[k] for k in ("ttft_s", "decode_ms_per_step", "decode_steps",
                                            "tokens_per_s", "peak_device_gib", "launches",
                                            "first_tokens")}
    del served
    torch.cuda.empty_cache()
    return info, launches


def _smoke_batches(cfg, seed=0):
    from repro_torch.data.synthetic import lm_batches
    data = lm_batches(cfg.vocab_size, TRAIN_SMOKE_T, TRAIN_SMOKE_B, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(TRAIN_SMOKE_STEPS):
        b = {"tokens": torch.from_numpy(next(data))}
        if cfg.frontend:
            b["frontend"] = torch.from_numpy((0.1 * rng.standard_normal(
                (TRAIN_SMOKE_B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32))
        out.append(b)
    return out


def train_smoke_vs_plain(dev):
    """Phase 6d: each smoke arch trained 3 steps on the card and on the CPU
    from the same float32 params and batches (losses within 1e-4
    relative), then the card's trained weights served greedy on both
    (continuous, 3 requests over 2 slots, seeded frontends): card tokens
    == CPU tokens. Then ``MP_SMOKE`` on each of ``MP_SMOKE_MESHES``, four
    shards on the card against four on the CPU (``train_smoke_mesh``)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.train_step import init_train, make_train_step
    out = {}
    for arch in TRAIN_SMOKE:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        opt_cfg = _train_opt(TRAIN_SMOKE_STEPS)
        params, opt = init_train(cfg, opt_cfg, seed=0, device=dev)
        host = lambda t: t.to("cpu", copy=True)                     # noqa: E731
        state = {"cuda": (params, opt), "cpu": (tree_map(host, params), tree_map(host, opt))}
        step = make_train_step(cfg, opt_cfg)
        losses = {}
        for where, (p, o) in state.items():
            losses[where] = []
            for b in _smoke_batches(cfg):
                b = {k: v.to(dev if where == "cuda" else "cpu") for k, v in b.items()}
                p, o, m = step(p, o, b)
                losses[where].append(float(m["loss"]))
            state[where] = (p, o)
        err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
        require(all(math.isfinite(x) for x in losses["cuda"]) and err <= TRAIN_LOSS_RTOL,
                f"{arch}: card losses {losses['cuda']} vs cpu {losses['cpu']}")
        trained = state["cuda"][0]
        rng = np.random.default_rng(7)
        reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                        max_new_tokens=m, frontend=_frontend(cfg, rng))
                for i, (n, m) in enumerate(((96, 9), (80, 5), (104, 7)))]
        fkv = _smoke_fkv("freekv", "none")
        toks = {}
        for where, p in (("cuda", trained), ("cpu", tree_map(host, trained))):
            eng = ServeEngine(cfg, fkv, p, max_len=192, batch_size=2,
                              state_dtype=torch.float32, device=dev if where == "cuda" else "cpu")
            outs = eng.generate(reqs)
            require(eng.last_logits_finite, f"non-finite logits ({where} {arch})")
            toks[where] = [o.tokens for o in outs]
        require(toks["cuda"] == toks["cpu"], f"{arch} trained: card tokens {toks['cuda']} vs "
                f"cpu {toks['cpu']}")
        out[arch] = {"losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
                     "max_loss_rel": err, "tokens": toks["cuda"][0],
                     "s": time.perf_counter() - t0}
        del state, trained
    for arch in MP_SMOKE:
        for dims in MP_SMOKE_MESHES:
            out[f"{arch} mesh {dims[0]}x{dims[1]}"] = train_smoke_mesh(dev, arch, dims)
    return out


def train_smoke_mesh(dev, arch, dims):
    """``arch`` trained ``TRAIN_SMOKE_STEPS`` steps on a ``dims`` mesh of
    shards on ``dev`` and on one of CPU shards, from the same seeded params
    and batches: losses within 1e-4 relative."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.sharding.rules import shard_params
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import make_train_step
    t0 = time.perf_counter()
    cfg = get_config(arch)
    opt_cfg = _train_opt(TRAIN_SMOKE_STEPS)
    host = init_params(cfg, seed=0, device="cpu")
    losses = {}
    for where in ("cuda", "cpu"):
        mesh = _mesh(dims, dev if where == "cuda" else "cpu")
        params = shard_params(cfg, host, mesh)
        opt = adamw_init(params, opt_cfg)
        step = make_train_step(cfg, opt_cfg, mesh=mesh)
        losses[where] = []
        for b in _smoke_batches(cfg):
            params, opt, m = step(params, opt, {k: v.to(mesh.primary) for k, v in b.items()})
            losses[where].append(float(m["loss"]))
        moved = dict(mesh.moved.bytes)
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    require(all(math.isfinite(x) for x in losses["cuda"]) and err <= TRAIN_LOSS_RTOL,
            f"{arch} {dims}: card losses {losses['cuda']} vs cpu {losses['cpu']}")
    return {"losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"], "max_loss_rel": err,
            "moved_bytes_per_step": moved, "s": time.perf_counter() - t0}


def _mesh(dims, device):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(dims[1], (str(device),) * (dims[0] * dims[1]))


def _mp_batches(cfg, B, T, dev):
    """lm_batches(seed=0) on ``dev``, each with seeded frames for a
    frontend arch (as _smoke_batches')."""
    from repro_torch.data.synthetic import lm_batches
    data = lm_batches(cfg.vocab_size, T, B, seed=0)
    rng = np.random.default_rng(0)
    while True:
        batch = {"tokens": torch.from_numpy(next(data)).to(dev)}
        if cfg.frontend:
            batch["frontend"] = torch.from_numpy((0.1 * rng.standard_normal(
                (B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)).to(dev)
        yield batch


def mp_grad_gate(dev, cfg, B, T):
    """The first batch's loss gradients of ``cfg`` (seeded float32 params) at
    (1, 1) and at (1, 2), shards on ``dev``: every leaf within MP_GRAD_RTOL
    relative L2 (MP_GRAD_ATOL absolute below a norm of MP_GRAD_ATOL).
    Returns the worst relative error and its leaf."""
    from repro_torch.models.model import forward_train, init_params
    from repro_torch.sharding.rules import gather_params, shard_params
    from repro_torch.training.optimizer import tree_leaves, tree_map
    host = init_params(cfg, seed=0, device=dev)
    batch = next(_mp_batches(cfg, B, T, dev))
    grads = []
    for dims in ((1, 1), (1, 2)):
        mesh = _mesh(dims, dev)
        sp = shard_params(cfg, host, mesh)
        leaves = [p.requires_grad_(True) for _, p in tree_leaves(sp)]
        loss, _ = forward_train(cfg, sp, batch, mesh=mesh)
        g = iter(torch.autograd.grad(loss, leaves))
        grads.append(tree_leaves(gather_params(tree_map(lambda _: next(g), sp), dev)))
        del sp, leaves, loss, g
    worst = (0.0, None)
    for (path, a), (_, b) in zip(*grads):
        norm, err = a.norm().item(), (a - b).norm().item()
        rel = err if norm < MP_GRAD_ATOL else err / norm
        require(rel <= (MP_GRAD_ATOL if norm < MP_GRAD_ATOL else MP_GRAD_RTOL),
                f"{cfg.name} (1, 2): gradient {path} {rel:.3g} from (1, 1)'s")
        worst = max(worst, (rel, "/".join(map(str, path))))
    del host, grads
    torch.cuda.empty_cache()
    return {"max_rel_l2": worst[0], "leaf": worst[1], "rtol": MP_GRAD_RTOL}


def train_mp_run(dev, ops, cfg, dims, B, T, opt_cfg):
    """``MP_STEPS`` train steps of ``cfg`` on a ``dims`` mesh of shards all on
    ``dev``, from init_train's seeded params and lm_batches(seed=0); in a
    freed allocator (what earlier phases leave allocated is reported
    beside the peak). Returns each step's loss, grad norm, seconds and
    bytes moved between shards by kind."""
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_step import init_train, make_train_step
    mesh = _mesh(dims, dev)
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t_run = time.perf_counter()
    params, opt = init_train(cfg, opt_cfg, seed=0, device=dev, mesh=mesh)
    step = make_train_step(cfg, opt_cfg, mesh=mesh)
    data = _mp_batches(cfg, B, T, dev)
    ops.reset_launches()
    rows = []
    for i in range(MP_STEPS):
        batch = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        dt = time.perf_counter() - t0
        require(math.isfinite(loss) and math.isfinite(gnorm),
                f"{cfg.name} {dims} step {i}: loss {loss}, grad norm {gnorm}")
        rows.append({"step": i, "loss": loss, "grad_norm": gnorm, "s": dt,
                     "moved_bytes": dict(mesh.moved.bytes)})
    launched = {fn.__name__: fn.launches for fn in ops.KERNELS}
    require(not any(launched.values()), f"a model-parallel train step launched a serving "
            f"kernel: {launched}")
    moved = rows[-1]["moved_bytes"]
    info = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": list(dims), "batch": B, "seq": T,
            "dtype": "float32", "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "params": sum(p.numel() for _, p in tree_leaves(params)), "steps": rows,
            "s_per_step_after_first": rows[-1]["s"], "tokens_per_s": B * T / rows[-1]["s"],
            "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "resident_before_gib": resident / 2 ** 30,
            "moved_bytes_per_step": moved,
            "nvlink_s_computed": {k: v / rl.NVLINK_BPS for k, v in moved.items()},
            "run_s": time.perf_counter() - t_run}
    del params, opt, step
    torch.cuda.empty_cache()
    return info


def train_mp_phase(dev, ops, phase6a):
    """Phase 6c: smollm-360m at full width on a (1, 2) mesh, held against
    phase 6a's first two steps (same AdamW, data and seed); deepseek-moe-16b
    at full width, depth cut to ``MP_DEEPSEEK_LAYERS``, at (1, 1) and (1, 4),
    held against each other. Losses and grad norms within 1e-4. Then
    ``MP_XARCH`` (xlstm-350m cut by ``mixer_cut``: the mLSTM by head, the
    sLSTM whole on shard 0, its first step's loss held; whisper-tiny: the encoder and the cross-attention by
    KV-head group) at (1, 1) and (1, 2), losses within MP_X_RTOL and the
    first batch's gradients within MP_GRAD_RTOL (``mp_grad_gate``)."""
    from repro_torch.configs import get_config

    def hold(info, steps, against, keys=("loss", "grad_norm"), rtol=TRAIN_LOSS_RTOL):
        """``info``'s ``keys`` within ``rtol`` of ``steps``'."""
        want = [{k: w[k] for k in keys} for w in steps[:MP_STEPS]]
        for r, w in zip(info["steps"], want):
            for k, v in w.items():
                require(abs(r[k] - v) <= rtol * abs(v),
                        f"{info['arch']} {info['mesh']} step {r['step']}: {k} {r[k]} against "
                        f"{against}'s {v}")
        info["against"] = {against: want}
        return info

    arch, dims, B, T = MP_SMOLLM
    smollm = train_mp_run(dev, ops, get_config(arch), dims, B, T, _train_opt(TRAIN_STEPS))
    arch, meshes, B, T = MP_DEEPSEEK
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=MP_DEEPSEEK_LAYERS,
                              n_periods=MP_DEEPSEEK_LAYERS - len(full.prelude))
    one, four = (train_mp_run(dev, ops, cfg, dims, B, T, _train_opt(MP_STEPS))
                 for dims in meshes)
    out = [hold(smollm, phase6a["steps"], "phase 6a (1 x 1)"), one,
           hold(four, one["steps"], str(meshes[0]))]
    for arch, B, T, cut, held in MP_XARCH:
        xcfg = mixer_cut(get_config(arch)) if cut else get_config(arch)
        x1, x2 = (train_mp_run(dev, ops, xcfg, dims, B, T, _train_opt(MP_STEPS))
                  for dims in ((1, 1), (1, 2)))
        x2 = hold(x2, x1["steps"][:held], "(1, 1)", keys=("loss",), rtol=MP_X_RTOL)
        x2["loss_rel_moves"] = [abs(a["loss"] - b["loss"]) / abs(a["loss"])
                                for a, b in zip(x1["steps"], x2["steps"])]
        x2["first_step_grads"] = mp_grad_gate(dev, xcfg, B, T)
        out += [x1, x2]
    return out


def log_mesh_phase(dev, ops, cfg, params, phase4, smi):
    """Phase 4g (``mesh_phase``) run and logged; returns its launches."""
    t0 = time.perf_counter()
    mesh_infos, mesh_gates, mesh_launches = mesh_phase(dev, ops, cfg, params, phase4)
    for info in mesh_infos:
        log("[mesh] " + json.dumps(info))
        mv = info["moved_bytes_per_step"]
        moved = (", ".join(f"{k} {v:.0f} B" for k, v in mv.items() if v) or "nothing")
        if info["run"] == "(h)":
            log(f"[mesh] {smi} | (h) {info['arch']} {info['layers']} layers mesh "
                f"{info['mesh'][0]}x{info['mesh'][1]}, draft_len {info['draft_len']} with "
                f"hints (shards on {dev}): tokens equal run (c)'s draft_len 0; accept rate "
                f"{info['accept_rate']:.3f}, {info['tokens_per_target_step']:.2f} tokens a "
                f"target step, {info['verify_steps']} verify steps + {info['idle_iterations']} "
                f"idle, decode {info['decode_ms_per_committed_token']:.2f} ms a committed "
                f"token; moved a step {moved}; run {info['run_s']:.1f} s")
            continue
        if "logit_gates" in info:
            g = info["logit_gates"]
            log(f"[mesh] {smi} | {info['run']} {info['arch']} {info['layers']} layers mesh "
                f"{info['mesh'][0]}x{info['mesh'][1]} (state shards "
                f"{json.dumps(info['state_shards'])}; shards on {dev}): 1 x 1 == no mesh "
                f"(tokens, launches); decode {info['decode_ms_per_step']:.2f} ms/step (no mesh "
                f"{info['no_mesh']['decode_ms_per_step']:.2f}), TTFT "
                f"{min(info['ttft_s']):.3f}-{max(info['ttft_s']):.3f} s (no mesh "
                f"{min(info['no_mesh']['ttft_s']):.3f}-{max(info['no_mesh']['ttft_s']):.3f}), "
                f"peak {info['peak_device_gib']:.2f} GiB; request 0 at "
                f"{info['logit_gate_layers']} layers: float32 logits within "
                f"{g['float32']['max_rel_logit_err']:.3g} of the largest |logit| (gate "
                f"{MESH_LOGIT_RTOL}, {len(g['float32']['flips'])} near-tie flips), bf16 "
                f"{g['bfloat16']['max_rel_logit_err']:.3g} with flips "
                f"{json.dumps(g['bfloat16']['flips'])}; first token differing from no mesh by "
                f"request {json.dumps(info['first_differing_token_vs_no_mesh'])}; moved a step "
                f"{moved}; run {info['run_s']:.1f} s")
            continue
        pr = info["profile"]
        log(f"[mesh] {smi} | {info['run']} {info['arch']} {info['layers']} layers mesh "
            f"{info['mesh'][0]}x{info['mesh'][1]} ({info['layout']}"
            + (f", fused step, overselect {info['sharded_overselect']}"
               if info["sharded_retrieval"] else "") + f"; shards on {dev}): decode "
            f"{info['decode_ms_per_step']:.2f} ms/step over {info['decode_steps']} steps, "
            f"TTFT {min(info['ttft_s']):.3f}-{max(info['ttft_s']):.3f} s, "
            f"{info['tokens_per_s']:.2f} tokens/s, peak {info['peak_device_gib']:.2f} GiB; "
            f"eager step {pr['wall_ms_per_step_unprofiled']:.2f} ms, "
            f"{pr['cpu_ops_per_step']} host ops, busy share {pr['device_busy_share']:.3f}; "
            f"moved a step {moved}, {info['nvlink_ms_per_step_computed']:.4f} ms over NVLink at "
            f"{rl.NVLINK_BPS / 1e9:.0f} GB/s (computed, not measured); run "
            f"{info['run_s']:.1f} s")
    a = mesh_infos[0]
    log(f"[mesh] (a) beside phase 4's no-mesh run (bf16, not gated): prefill logits rel "
        f"max |err| {a['bf16_prefill_logits_rel_max_err_vs_no_mesh']:.4g}, first "
        f"differing token by request {json.dumps(a['first_differing_token_vs_no_mesh'])}")
    log("[mesh] gates " + json.dumps(mesh_gates))
    g = mesh_gates["f32_2x2"]
    log(f"[mesh] 1 x 1 mesh == no mesh ({mesh_gates['bit_1x1']['arch']}): tokens and "
        f"launches bit-equal; float32 {g['arch']} {g['layers']} layers at 2x2: logits within "
        f"{g['max_rel_logit_err']:.3g} of the largest |logit| (gate {g['rtol']}), "
        f"{len(g['flips'])} near-tie flips, {g['requests_compared_to_the_end']} of {B} "
        f"requests compared to the end")
    f = mesh_gates["fused_card_vs_cpu"]
    log(f"[mesh] fused step {f['arch']} 1x{MESH_SHARDS}, card == CPU shards over "
        f"{f['steps']} steps: ids, counters and state exact, output max |err| "
        f"{f['output_max_abs_err_card_vs_cpu']:.3g} (TOL {f['tol']}), corrected heads a step "
        f"{f['corrected_heads_per_step']}, {f['s']:.1f} s")
    log(f"[mesh] phase 4g in {time.perf_counter() - t0:.1f} s")
    return mesh_launches


KERNEL_META = {   # name -> (source, the TPU kernel it replaces)
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:69"),
    "page_scores": ("src/repro_torch/kernels/csrc/page_scores.cu",
                    "src/repro/kernels/page_scores.py:36"),
    "recall_gather": ("src/repro_torch/kernels/csrc/recall_gather.cu",
                      "src/repro/kernels/recall_gather.py:228"),
    "recall_gather_quant": ("src/repro_torch/kernels/csrc/recall_gather_quant.cu",
                            "src/repro/kernels/recall_gather.py:185"),
    "page_summary": ("src/repro_torch/kernels/csrc/page_summary.cu",
                     "src/repro/kernels/page_summary.py:19"),
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill.py:73"),
    "recall_values": ("src/repro_torch/kernels/csrc/recall_gather.cu",
                      "src/repro/kernels/recall_gather.py:228 recall_gather(values_only=True)"),
    "recall_values_quant": ("src/repro_torch/kernels/csrc/recall_gather_quant.cu",
                            "src/repro/kernels/recall_gather.py:185 "
                            "recall_gather_quant(values_only=True)"),
    "centroid_scores": ("src/repro_torch/kernels/csrc/page_scores.cu",
                        "src/repro/kernels/centroid_scores.py:40"),
    "select_pages": ("src/repro_torch/kernels/csrc/page_scores.cu",
                     "src/repro/kernels/page_scores.py:36 page_scores, fused with "
                     "src/repro/core/selection.py:74-112 (pooling, mask, top-k)"),
    "centroid_candidates": ("src/repro_torch/kernels/csrc/page_scores.cu",
                            "src/repro/kernels/centroid_scores.py:40 centroid_scores, fused "
                            "with src/repro/core/centroid_index.py:254-287"),
    "fill_pages": ("src/repro_torch/kernels/csrc/page_summary.cu",
                   "src/repro/kernels/page_summary.py:19 page_summary, fused with the pool "
                   "fill of src/repro/core/paging.py:178-203"),
    "complete_page": ("src/repro_torch/kernels/csrc/page_summary.cu",
                      "src/repro/kernels/page_summary.py:19 page_summary, fused with the "
                      "masked page completion of src/repro/core/paging.py:206-254"),
    "paged_attention_lse": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:69, with the partials of "
                            "src/repro/core/sharded_retrieval.py:216-232 (_partial_attend)"),
    "select_pages_shard": ("src/repro_torch/kernels/csrc/page_scores.cu",
                           "src/repro/kernels/page_scores.py:36 page_scores, fused with the "
                           "shard-local selection of src/repro/core/sharded_retrieval.py:292-306"),
    "complete_page_shard": ("src/repro_torch/kernels/csrc/page_summary.cu",
                            "src/repro/kernels/page_summary.py:19 page_summary, fused with the "
                            "owner-masked page write of "
                            "src/repro/core/sharded_retrieval.py:271-290"),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phase")
    args = ap.parse_args()

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    log(smi)                                   # as nvidia-smi gives it
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build, ops, ref
    dev = torch.device("cuda", 0)
    log("[device] PCIe link " + json.dumps(link_info(dev)))

    # phase 2: build
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.load(name)
    log(f"[build] {len(build.SOURCES)} sources ({len(ops.KERNELS)} kernels) built and "
        f"loaded in {time.perf_counter() - t0:.1f} s")
    for name, out in build.BUILD_LOG.items():
        for line in out.splitlines():
            if ("registers" in line or "spill" in line or "error" in line.lower()
                    or "Performance Loss" in line):
                log(f"[build] {name}: {line.strip()}")

    mark("build")
    # phase 3: kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    checks = {"paged_attention": check_paged_attention, "page_scores": check_page_scores,
              "recall_gather": check_recall_gather,
              "recall_gather_quant": check_recall_gather_quant,
              "page_summary": check_page_summary, "flash_prefill": check_flash_prefill,
              "recall_values": check_recall_values,
              "recall_values_quant": check_recall_values_quant,
              "centroid_scores": check_centroid_scores, "select_pages": check_select_pages,
              "centroid_candidates": check_centroid_candidates, "fill_pages": check_fill_pages,
              "complete_page": check_complete_page,
              "paged_attention_lse": check_paged_attention_lse,
              "select_pages_shard": check_select_pages_shard,
              "complete_page_shard": check_complete_page_shard}
    require(set(checks) == {fn.__name__ for fn in ops.KERNELS} == set(KERNEL_META),
            "a kernel has no check")
    kernels = []
    for fn in ops.KERNELS:
        t0 = time.perf_counter()
        k = checks[fn.__name__](ops, ref, dev, gen)
        kernels.append(k)
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        if "library_max_abs_err" in k:
            lib += (f" (its max|err| {k['library_max_abs_err']:.3g}, within TOL: "
                    f"{k['library_within_tol']})")
        if "composition_ms" in k:
            lib += f" | replaced composition {k['composition_ms']:.4f} ms"
        log(f"[kernel] {k['name']}: max|err| {k['max_abs_err']:.3g} | "
            f"{k['kernel_ms']:.4f} ms vs bound {k['bound_ms']:.4f} ms | plain "
            f"{k['plain_ms']:.4f} ms | library {lib} | {time.perf_counter() - t0:.1f} s")
        for what in ("static_batch", "extension", "bidirectional", "int8", "no_completion"):
            if what not in k:
                continue
            sb = k[what]
            extra = "".join(f" | {label} {sb[key]:.4f} ms" for key, label in (
                ("plain_ms", "plain"), ("library_ms", "library"),
                ("composition_ms", "replaced composition"),
                ("kernel_call_ms", "call")) if key in sb)
            log(f"[kernel] {k['name']} {what} {sb.get('shape', '')}: {sb['kernel_ms']:.4f} ms "
                f"vs bound {sb['bound_ms']:.4f} ms{extra}")
        torch.cuda.empty_cache()
    rows = {k["name"]: k for k in kernels}
    # the kernels at the other served archs' shapes (G 7/3/2/1, d_head
    # 128/64/256/80, 4 to 32 KV heads, gemma2's softcap and window)
    t0 = time.perf_counter()
    shapes = {"paged_attention": check_paged_attention_shapes(ops, ref, dev, gen),
              "flash_prefill": check_flash_prefill_shapes(ops, ref, dev, gen),
              "select_pages": check_select_pages_shapes(ops, ref, dev, gen),
              "recall_gather": check_recall_gather_shapes(ops, ref, dev, gen)}
    fills = check_fill_shapes(ops, ref, dev, gen)
    for name in ("fill_pages", "complete_page"):
        shapes[name] = {arch: r[name] for arch, r in fills.items()}
    for name, by_arch in shapes.items():
        rows[name]["arch_shapes"] = by_arch
        for arch, r in by_arch.items():
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            log(f"[kernel] {name} {arch} {r['shape']}: max|err| {r['max_abs_err']:.3g} | "
                f"{r['kernel_ms']:.4f} ms vs bound {r['bound_ms']:.4f} ms | plain "
                f"{r['plain_ms']:.4f} ms | library {lib}")
    log(f"[kernel] the other archs' shapes held and timed in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    ext = rows["flash_prefill"]["extension"]
    log(f"[kernel] flash_prefill extension max|err| by case: {json.dumps(ext['max_abs_err_cases'])}"
        f"; SDPA lower-right max|err| {ext['library_max_abs_err']:.3g}, within TOL: "
        f"{ext['library_within_tol']}")
    bid = rows["flash_prefill"]["bidirectional"]
    log(f"[kernel] flash_prefill bidirectional (whisper-tiny's encoder) max|err| by case: "
        f"{json.dumps(bid['max_abs_err_cases'])}; SDPA (no mask) max|err| "
        f"{bid['library_max_abs_err']:.3g}, within TOL: {bid['library_within_tol']}")
    for name in ("recall_gather", "recall_values", "recall_gather_quant", "recall_values_quant"):
        k = rows[name]
        log(f"[kernel] {name} from the pinned pool: {k['kernel_ms']:.4f} ms, the link's "
            f"ceiling (copy_ of the same {k['moved_bytes']} B) {k['link_ms']:.4f} ms, ratio "
            f"{k['kernel_ms'] / k['link_ms']:.3f}; grid {k['host_grid_blocks']} blocks "
            f"({k['host_sms']:g} SMs at {k['blocks_per_sm']} an SM); "
            f"{k['device_grid_blocks']} blocks from a device pool")
    launches = {k["name"]: None for k in kernels}
    wide_launches, spec_launches, service_launches, train_launches = {}, {}, {}, {}
    tp_launches, mesh_launches = {}, {}
    share = None
    if not args.kernels_only:
        mark("phase 3")
        # phase 3b: the MoE FFN and the Mamba mixer at full width
        t0 = time.perf_counter()
        moe_info = moe_layer_phase(dev)
        log("[moe] " + json.dumps(moe_info))
        for n, r in moe_info["fp32"].items():
            log(f"[moe] fp32 N={n}: apply_moe vs the dense oracle max|err| "
                f"{r['max_abs_err_vs_oracle']:.3g} (tolerance 1e-4), capacity {r['capacity']}, "
                f"{r['dropped']} assignments dropped")
        for n, r in moe_info["bf16"].items():
            log(f"[moe] bf16 N={n}: {r['ms']:.4f} ms (call {r['call_ms']:.4f} ms) vs bound "
                f"{r['bound_reference_design']['bound_ms']:.4f} ms (all 64 experts at "
                f"capacity, by {r['bound_reference_design']['bound_by']}) and "
                f"{r['bound_routed']['bound_ms']:.4f} ms (the {r['experts_used']} routed "
                f"experts, by {r['bound_routed']['bound_by']}); two runs bit-equal"
                + ("; no host sync under sync debug mode \"error\"" if r["sync_free"] else ""))
        ssm_info = ssm_layer_phase(dev)
        log("[ssm] " + json.dumps(ssm_info))
        dec, pre = ssm_info["decode_b4"], ssm_info["prefill_t2048"]
        log(f"[ssm] jamba Mamba layer ({ssm_info['layer']}): {ssm_info['chain_steps']} chained "
            f"decode steps vs mamba_forward max|err| "
            f"{json.dumps(ssm_info['max_abs_err_chain_vs_forward'])} (tolerance 1e-4); decode "
            f"B=4 {dec['ms']:.4f} ms (call {dec['call_ms']:.4f} ms) vs bound "
            f"{dec['bound_ms']:.4f} ms by {dec['bound_by']}, no host sync under sync debug mode "
            f"\"error\"; prefill T=2048 {pre['ms']:.4f} ms (call {pre['call_ms']:.4f} ms) vs "
            f"bound {pre['bound_ms']:.4f} ms by {pre['bound_by']}; "
            f"{time.perf_counter() - t0:.1f} s for both")
        t0 = time.perf_counter()
        xl = xlstm_layer_phase(dev)
        log("[xlstm] " + json.dumps(xl))
        for kind in ("mlstm", "slstm"):
            dec, pre = xl[kind]["decode_b4"], xl[kind]["prefill_t2048"]
            log(f"[xlstm] xlstm-350m {kind} layer ({xl['layer']}): {xl['chain_steps']} chained "
                f"decode steps vs the forward max|err| "
                f"{json.dumps(xl[kind]['max_abs_err_chain_vs_forward'])} (tolerance 1e-4); "
                f"decode B=4 {dec['ms']:.4f} ms (call {dec['call_ms']:.4f} ms) vs bound "
                f"{dec['bound_ms']:.4f} ms by {dec['bound_by']}, no host sync under sync debug "
                f"mode \"error\"; prefill T=2048 {pre['ms']:.4f} ms (call {pre['call_ms']:.4f} "
                f"ms) vs bound {pre['bound_ms']:.4f} ms by {pre['bound_by']}")
        log(f"[xlstm] {time.perf_counter() - t0:.1f} s for both layers")
        t0 = time.perf_counter()
        mixers = mixer_mesh_phase(dev)
        log("[mixer-mesh] " + json.dumps(mixers))
        for key, r in mixers.items():
            log(f"[mixer-mesh] {smi} | {key} (float32, B={r['batch']}, state on "
                f"{r['shards_holding_state']} shard(s), every shard on {dev}): prefill of "
                f"{r['prefill_tokens']} tokens and {r['decode_steps']} decode steps against the "
                f"whole form max|err| {json.dumps(r['max_abs_err'])} (TOL {r['tol']}); decode "
                f"step {r['mesh_step_ms']:.4f} ms (call {r['mesh_step_call_ms']:.4f} ms) against "
                f"the whole form's {r['whole_step_ms']:.4f} ms (call "
                f"{r['whole_step_call_ms']:.4f} ms); moved a step "
                f"{json.dumps(r['moved_bytes_per_step'])} B, no weight; {r['s']:.1f} s")
        log(f"[mixer-mesh] {time.perf_counter() - t0:.1f} s for the three layers")
        mark("phase 3b")
        # phase 4: main path at full width: the static path, then every
        # retriever and pool tier through the continuous scheduler
        cfg, params = llama_params(dev)
        launches = {k["name"]: 0 for k in kernels}
        compare, phase4 = {}, {}
        for scheduler, method, kv_quant in [("static", "freekv", "none")] + [
                ("continuous", m, q) for m, q in RUNS]:
            t0 = time.perf_counter()
            full = (method, kv_quant) == ("freekv", "none")
            info, run = main_path(dev, ops, *((cfg, params) if full else half_depth(cfg, params)),
                                  method, kv_quant, scheduler)
            info["run_s"] = time.perf_counter() - t0
            tokens = info.pop("tokens")
            if scheduler == "continuous":
                phase4[(method, kv_quant)] = {"tokens": tokens, "info": info, "launches": run}
            log("[main] " + json.dumps(info))
            log(f"[main] {scheduler} {method}/{kv_quant}: {info['requests']} requests over "
                f"{B} slots, TTFT {min(info['ttft_s']):.3f}-{max(info['ttft_s']):.3f} s, "
                f"decode {info['decode_ms_per_step']:.2f} ms/step over {info['decode_steps']} "
                f"steps, {info['host_syncs_per_token']:.4f} host reads a token, "
                f"{info['tokens_per_s']:.2f} tokens/s, peak {info['peak_device_gib']:.2f} GiB")
            if "profile" in info:
                pr = info["profile"]
                log(f"[main] {method}/{kv_quant}: eager decode step "
                    f"{pr['wall_ms_per_step_unprofiled']:.2f} ms, {pr['cpu_ops_per_step']} host "
                    f"ops, {pr['device_ops_per_step']:.1f} device operations, busy share "
                    f"{pr['device_busy_share']:.3f}; spans a step (host ms, device ms): "
                    + json.dumps({k: (round(v["host_ms_per_step"], 3),
                                      round(v["device_ms_per_step"], 3))
                                  for k, v in pr["spans"].items()}))
                if "completion" in pr:
                    log(f"[main] {method}/{kv_quant}: eager step, no row completing a page / "
                        "every row completing one: " + json.dumps(pr["completion"]))
                if "window" in pr:
                    for what, w in ((f"continuous window of {MAIN_WINDOW} steps", pr["window"]),
                                    ("static engine step", pr["window"]["static_step"])):
                        log(f"[main] {method}/{kv_quant}: {what}: "
                            f"{w['wall_ms_per_step_unprofiled']:.2f} ms, {w['cpu_ops_per_step']} "
                            f"host ops, {w['device_ops_per_step']:.1f} device operations, busy "
                            f"share {w['device_busy_share']:.3f}, {w['host_syncs_per_step']:g} "
                            f"host syncs a step (runtime calls: {w['sync_calls']})")
            for name, n in run.items():
                launches[name] += n
            if (method, kv_quant) == ("freekv", "none"):
                compare[scheduler] = info
                if scheduler == "continuous":
                    served_tokens = tokens
                share = {"topup": info["topup_valid_share"], "staged": info["staged_valid_share"]}
        keys = ("decode_ms_per_step", "host_syncs_per_step", "host_syncs_per_token",
                "tokens_per_s", "slot_occupancy")
        log("[main] freekv/none static vs continuous: " + json.dumps(
            {sch: {k: compare[sch][k] for k in keys} for sch in ("static", "continuous")}))
        cost = cost_phase(dev, ops, cfg, params, compare["continuous"]["decode_ms_per_step"])
        log("[cost] " + json.dumps(cost))
        log(f"[cost] {smi} | llama31-8b serve_step, B {B}, context {CONTEXT}: counted on the "
            f"card == on meta, {cost['flops']:.4e} FLOPs, {cost['bytes']:.4e} B "
            f"({cost['aten_bytes']:.4e} by torch ops), {cost['link_bytes']:.4e} B over PCIe, "
            f"launches {json.dumps(cost['launches'])}; analytic bound "
            f"{cost['analytic_bound_ms']:.3f} ms all over HBM ("
            + ", ".join(f"{k} {v / 1e9:.4f} GB" for k, v in cost["analytic_parts_bytes"].items())
            + f"), {cost['analytic_bound_pool_pcie_ms']:.3f} ms with the pool over PCIe; "
            f"measured continuous freekv/none {cost['measured_ms_per_step']:.2f} ms/step: share "
            f"{cost['share']:.4f} ({cost['share_pool_pcie']:.4f} with the pool over PCIe); "
            f"{cost['phase_s']:.1f} s")
        mark("phase 4")
        # phase 4b: chunked prefill, the prefix cache and preemption, each
        # off and on over the same traffic
        t0 = time.perf_counter()
        feats = feature_pairs(dev, ops, *half_depth(cfg, params))
        log("[features] " + json.dumps(feats))
        ch, pc, pr = feats["chunked"], feats["prefix_cache"], feats["preempt"]
        log(f"[features] chunked prefill (budget {ch['budget']}): max token gap s off "
            f"{ch['off']['max_token_gap_s']} on {ch['on']['max_token_gap_s']}; "
            f"{ch['on']['prefill_chunks']} chunks; launches on "
            f"{json.dumps(ch['on']['launches'])}; tokens equal "
            f"{[a['equal'] for a in ch['agreement']]} of {[a['of'] for a in ch['agreement']]}")
        log(f"[features] prefix cache: TTFT s off {pc['off']['ttft_s']} on {pc['on']['ttft_s']}; "
            f"hits {pc['on']['prefix_hit_tokens']}; timed copies {json.dumps(pc['on']['copies_timed'])}; "
            f"tokens equal {[a['equal'] for a in pc['agreement']]}")
        log(f"[features] preemption: victims {pr['victims']}, priority request TTFT s off "
            f"{pr['off']['ttft_s'][4]:.3f} on {pr['on']['ttft_s'][4]:.3f}; swap "
            f"{pr['on']['swap_out_bytes']:.0f} B out, {pr['on']['swap_in_bytes']:.0f} B in; "
            f"timed swap {json.dumps(pr['on']['swap_timed'])}; tokens equal "
            f"{[a['equal'] for a in pr['agreement']]}; "
            f"{time.perf_counter() - t0:.1f} s for the six runs")
        mark("phase 4b")
        # phase 4c: the other archs and retrievers at full width
        t0 = time.perf_counter()
        wide_launches = wide_runs(dev, ops, cfg, params)
        for name, n in xarch_runs(dev, ops).items():
            wide_launches[name] = wide_launches.get(name, 0) + n
        log(f"[wide] {len(WIDE_RUNS) + len(XARCH_RUNS)} runs in "
            f"{time.perf_counter() - t0:.1f} s")
        mark("phase 4c")
        # phase 4d: the sampler and speculative decoding
        spec_launches = spec_phase(dev, ops, *half_depth(cfg, params))
        mark("phase 4d")
        # phase 4e: live serving through the HTTP front-end
        serve, service_launches = serve_phase(dev, ops, cfg, params, served_tokens,
                                              compare["continuous"]["decode_ms_per_step"])
        log("[serve] " + json.dumps(serve))
        log(f"[serve] {serve['requests']} streaming clients, one hung up after "
            f"{serve['hung_up']['read']} tokens (the server made {serve['hung_up']['server_tokens']}"
            f"): client TTFT p50 {serve['client_ttft_s']['p50']:.3f} s p99 "
            f"{serve['client_ttft_s']['p99']:.3f} s, token gap p50 "
            f"{1e3 * serve['client_token_gap_s']['p50']:.2f} ms p99 "
            f"{1e3 * serve['client_token_gap_s']['p99']:.2f} ms; SLO attainment "
            f"{serve['slo']['attainment']:.3f} ({serve['slo']['attained']}/{serve['slo']['tagged']}), "
            f"goodput {serve['slo']['goodput_tokens_per_s']:.2f} of {serve['tokens_per_s']:.2f} "
            f"tokens/s; decode {serve['decode_ms_per_step']:.2f} ms/step (phase 4's continuous "
            f"freekv/none {serve['direct_decode_ms_per_step']:.2f}, the same engine's generate() "
            f"of the nine {serve['same_engine_direct_decode_ms_per_step']:.2f}); "
            f"{serve['host_syncs_per_token']:.4f} host reads a token; peak "
            f"{serve['peak_device_gib']:.2f} GiB; phase {serve['phase_s']:.1f} s")
        mark("phase 4e")
        # phase 4f: KV-head-group tensor parallelism at full width
        t0 = time.perf_counter()
        tp_infos, tp_launches = tp_phase(dev, ops, cfg, params, phase4)
        for info in tp_infos:
            log("[tp] " + json.dumps(info))
            pr = info.get("profile")
            log(f"[tp] {smi} | llama31-8b {info['layers']} layers {info['run']}: tokens, steps, "
                f"exposed/hidden bytes equal phase 4's tp=1, the shards' own "
                f"{json.dumps(info['tp']['shard_transfer_bytes'])} B; decode "
                f"{info['decode_ms_per_step']:.2f} ms/step (tp=1 "
                f"{info['tp1_decode_ms_per_step']:.2f}), TTFT "
                f"{min(info['ttft_s']):.3f}-{max(info['ttft_s']):.3f} s (tp=1 "
                f"{min(info['tp1_ttft_s']):.3f}-{max(info['tp1_ttft_s']):.3f}), "
                f"{info['tokens_per_s']:.2f} tokens/s, peak {info['peak_device_gib']:.2f} GiB; "
                f"launches {json.dumps({k: v for k, v in info['launches'].items() if v})}"
                + ("" if pr is None else
                   f"; eager step {pr['wall_ms_per_step_unprofiled']:.2f} ms, "
                   f"{pr['cpu_ops_per_step']} host ops, busy share "
                   f"{pr['device_busy_share']:.3f} (tp=1 "
                   f"{info['tp1_profile']['wall_ms_per_step_unprofiled']:.2f} ms, "
                   f"{info['tp1_profile']['cpu_ops_per_step']} host ops, busy share "
                   f"{info['tp1_profile']['device_busy_share']:.3f})"))
        log(f"[tp] {len(tp_infos)} runs ({', '.join(i['run'] for i in tp_infos)}) in "
            f"{time.perf_counter() - t0:.1f} s")
        mark("phase 4f")
        # phase 4g: serving over a ("data", "model") compute mesh
        mesh_launches = log_mesh_phase(dev, ops, cfg, params, phase4, smi)
        del params
        torch.cuda.empty_cache()
        require(all(0 <= v <= 1 for v in share.values()), f"valid shares out of range: {share}")
        log("[main] shadowkv low-rank keys: " + json.dumps(time_low_rank_keys(dev, cfg, gen)))
    # the overlap line, and the gathers again at the valid share of freekv/none's
    # two recall launches, in a fresh process: one whose profiler has run many
    # sessions can lose device events and serialize the two streams
    bench = run_gather_bench(share)
    for s_, ovl in bench["overlap"].items():
        log(f"[overlap] 32 paged_attention alone and beside recall_gather (valid share {s_}) "
            "on the side stream: " + json.dumps(ovl))
    if share is not None:
        log(f"[kernel] gathers at freekv/none's valid share {json.dumps(share)}: "
            + json.dumps(bench["gathers"]))
        for name, r in bench["gathers"].items():
            base, _, bits = name.partition(" int")
            ms = {kind: r["by_share"][str(v)]["ms"] for kind, v in share.items()}
            target = rows[base]["int4"] if bits == "4" else rows[base]
            target.update(real_share=share, real_share_ms=ms)
    if not args.kernels_only:
        mark("phase 4g and the gathers")
        # phase 5: kernel path == plain path
        for method, kv_quant in (("freekv", "none"), ("freekv", "int8"), ("freekv", "int4"),
                                 ("shadowkv", "none"), ("shadowkv", "int8"),
                                 ("shadowkv", "int4"), ("centroid", "none"),
                                 ("centroid", "int8")):
            toks = kernel_vs_plain_end_to_end(dev, method, kv_quant)
            log(f"[equal] granite-3-8b-smoke fp32 {method} kv_quant={kv_quant}: card == cpu "
                f"greedy tokens, e.g. {toks[0][:8]}")
        for method, kv_quant in (("freekv", "none"), ("freekv", "int8"), ("shadowkv", "none"),
                                 ("centroid", "none")):
            toks, steps, syncs = continuous_vs_plain(dev, method, kv_quant)
            log(f"[equal] granite-3-8b-smoke fp32 continuous {method} kv_quant={kv_quant}: card "
                f"== cpu greedy tokens and steps ({steps} steps, {syncs} host reads), 5 requests "
                f"over 2 slots, eos in a window, e.g. {toks[2]}")
        for name, r in features_vs_plain(dev).items():
            log(f"[equal] granite-3-8b-smoke fp32 continuous freekv, {name}: card == cpu greedy "
                f"tokens and counts " + json.dumps(r))
        for label, r in new_paths_vs_plain(dev).items():
            log(f"[equal] {r['arch']} fp32 continuous, {label}: card == cpu greedy tokens and "
                "steps " + json.dumps(r))
        for label, r in moe_paths_vs_plain(dev).items():
            log(f"[equal] {label}, fp32 continuous: card == cpu greedy tokens, steps and "
                "counts " + json.dumps(r))
        for label, r in xarch_paths_vs_plain(dev).items():
            log(f"[equal] {label}, fp32: card == cpu greedy tokens, steps and counts, chunk "
                "budget and prefix cache off " + json.dumps(r))
        for label, t in spec_vs_plain(dev).items():
            log(f"[equal] granite-3-8b-smoke fp32 continuous freekv draft_len 3, {label}: "
                f"card == cpu == draft_len 0 tokens, e.g. {t}")
        for name, r in tp_paths_vs_plain(dev).items():
            log(f"[equal] granite-3-8b-smoke fp32 tp{TP} (two shards on cuda:0), {name}: card "
                f"== cpu == cpu tp1 greedy tokens, steps and counts " + json.dumps(r))
        n = centroid_index_equals_rebuild(dev)
        log(f"[equal] granite-3-8b-smoke fp32 centroid: the index kept on the card equals "
            f"its rebuild in every layer after 20 steps ({n} re-centers)")
        mark("phase 5")
        # phase 6: training at full width, the checkpoint round trip, the
        # trained weights served; the smoke archs' steps card == CPU
        t_phase = time.perf_counter()
        train, train_launches = train_full_width(dev, ops)
        log("[train] " + json.dumps(train))
        ck, sv = train["checkpoint"], train["serve"]
        log(f"[train] {smi} | {TRAIN_ARCH} float32 B={TRAIN_B} T={TRAIN_T} "
            f"({train['params']} params), allow_tf32 {train['allow_tf32']}: "
            f"{train['s_per_step_after_first']:.3f} s/step after the first, "
            f"{train['tokens_per_s']:.0f} tokens/s, {train['flops_per_step']:.3e} FLOPs a step "
            f"against the float32 bound {train['bound_s_float32']:.3f} s (share "
            f"{train['bound_share']:.3f}, {train['achieved_tflops']:.2f} TFLOP/s), peak "
            f"{train['peak_device_gib']:.2f} GiB ({train['resident_before_gib']:.2f} of it "
            f"allocated before the phase); losses "
            f"{[round(r['loss'], 4) for r in train['steps']]}")
        pr = train["profile_forward_backward"]
        if pr["device_ms"] is None:
            log(f"[train] profiled forward + backward: {pr['wall_ms']:.1f} ms wall; device "
                "time not measured (the profiler recorded no device event)")
        else:
            log(f"[train] profiled forward + backward: {pr['wall_ms']:.1f} ms wall, "
                f"{pr['device_ms']:.1f} device ms, busy share {pr['busy_share']:.3f}; top rows "
                + json.dumps([(r["kernel"], round(r["ms"], 1), r["count"]) for r in pr["top"]]))
        log(f"[train] checkpoint of {ck['leaves']} leaves, {ck['bytes']} B: save "
            f"{ck['save_s']:.2f} s, restore {ck['restore_s']:.2f} s, every leaf bit-equal; "
            f"the trained weights (bf16) served freekv/none: TTFT "
            f"{min(sv['ttft_s']):.3f}-{max(sv['ttft_s']):.3f} s, decode "
            f"{sv['decode_ms_per_step']:.2f} ms/step, launches {json.dumps(sv['launches'])}")
        # 6c: model-parallel training at full width
        t0 = time.perf_counter()
        for info in train_mp_phase(dev, ops, train):
            log("[mp] " + json.dumps(info))
            moved = info["moved_bytes_per_step"]
            log(f"[mp] {smi} | {info['arch']} {info['layers']} layers float32 B={info['batch']} "
                f"T={info['seq']} mesh {info['mesh'][0]}x{info['mesh'][1]} (shards on {dev}): "
                f"losses {[round(r['loss'], 5) for r in info['steps']]}, grad norms "
                f"{[round(r['grad_norm'], 5) for r in info['steps']]}"
                + (f" against {json.dumps(info['against'])}" if "against" in info else "")
                + (f" (losses' relative moves {info['loss_rel_moves']}; the first batch's "
                   f"gradients within {info['first_step_grads']['max_rel_l2']:.3g} relative L2, "
                   f"worst {info['first_step_grads']['leaf']})"
                   if "first_step_grads" in info else "")
                + f"; {info['s_per_step_after_first']:.3f} s/step after the first "
                f"({info['steps'][0]['s']:.3f} s the first), {info['tokens_per_s']:.0f} tokens/s,"
                f" peak {info['peak_device_gib']:.2f} GiB ({info['resident_before_gib']:.2f} "
                f"allocated before); moved between shards a step "
                + ", ".join(f"{k} {v} B" for k, v in moved.items())
                + f", {sum(moved.values()) / rl.NVLINK_BPS * 1e3:.3f} ms over NVLink at "
                f"{rl.NVLINK_BPS / 1e9:.0f} GB/s (computed, not measured); run "
                f"{info['run_s']:.1f} s")
        log(f"[mp] phase 6c in {time.perf_counter() - t0:.1f} s")
        # 6d: the smoke archs' steps card == CPU, on one device and on meshes
        for arch, r in train_smoke_vs_plain(dev).items():
            if "tokens" not in r:
                log(f"[equal] {arch} trained {TRAIN_SMOKE_STEPS} steps (B={TRAIN_SMOKE_B}, "
                    f"T={TRAIN_SMOKE_T}): four shards on the card, losses {r['losses_cuda']} vs "
                    f"four on the cpu {r['losses_cpu']} (max rel {r['max_loss_rel']:.3g}); "
                    f"moved a step {json.dumps(r['moved_bytes_per_step'])}; {r['s']:.1f} s")
                continue
            log(f"[equal] {arch} trained {TRAIN_SMOKE_STEPS} steps (B={TRAIN_SMOKE_B}, "
                f"T={TRAIN_SMOKE_T}): card losses {r['losses_cuda']} vs cpu {r['losses_cpu']} "
                f"(max rel {r['max_loss_rel']:.3g}); served card == cpu greedy tokens, e.g. "
                f"{r['tokens']}; {r['s']:.1f} s")
        log(f"[train] phase 6 in {time.perf_counter() - t_phase:.1f} s")

    from repro_torch.launch.gather_bench import EVENT_TIMED
    log(f"[timing] device times taken with CUDA events behind a spin because the profiler "
        f"dropped three sessions' device events: {len(EVENT_TIMED)} (iters, ms) {EVENT_TIMED}")
    line = []
    for k in kernels:
        src, replaces = KERNEL_META[k["name"]]
        # the fused step's forms run on phase 4g's path: their launches are its
        main_launches = (mesh_launches.get(k["name"]) if k["name"] in MESH_FORMS
                         else launches[k["name"]])
        line.append({"name": k["name"], "route": "cuda", "source": src, "replaces": replaces,
                     "launches": main_launches,
                     "wide_launches": wide_launches.get(k["name"]),
                     "spec_launches": spec_launches.get(k["name"]),
                     "service_launches": service_launches.get(k["name"]),
                     "train_launches": train_launches.get(k["name"]),
                     "tp_launches": tp_launches.get(k["name"]),
                     "mesh_launches": mesh_launches.get(k["name"]),
                     "max_abs_err": k["max_abs_err"],
                     "ms": k["kernel_ms"], **k})
    mark("phase 6")
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
