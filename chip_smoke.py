#!/usr/bin/env python3
"""Chip smoke test of the ``repro_torch`` port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (each prints its lines; any failure ends the run with a nonzero
exit and no result line):

1. device  -- the card's name and power limit (``nvidia-smi``);
2. build   -- every kernel of ``src/repro_torch/csrc`` compiled with
   ``nvcc`` for sm_90a, one process per source, and the ``-Xptxas -v``
   summary;
3. kernels -- each hand-written kernel against its plain torch version on
   the card, at the shapes of llama3-8b's and mixtral-8x7b's serving
   paths, and at the new shapes of deepseek-moe-16b's, stablelm-3b's,
   glm4-9b's, mamba2-130m's and jamba-1.5-large-398b's (K3 at deepseek's
   expert and stablelm's gate/up load shapes, w3, at mamba2's in_proj,
   w4, and at a jamba expert's gate, w2; K1 at mamba2's in_proj, N 3352
   -- its last 64-column tile partial -- at M 4 and 256, and its
   out_proj, N 768, K 1536, w4, and at jamba's in_proj, N 34944, K 8192,
   w2, at M 4 and 256; K2 at jamba's decode, 8 kv heads of group 8; fused
   K4 and K4-bs at jamba's 16 experts, gate/up 24576 x 8192 and down
   8192 x 24576, w2, at its traced steps' segment heights;
   K1 at deepseek's dense down projection, K = 10944: weight
   rows of 342 words, not a multiple of 4, at M 4 and 256, w3, and at
   stablelm's dual gate/up, N 6912, K 2560, w3, at M 4; K2 at
   stablelm's decode, 32 kv heads of head dim 80 -- three packed words --
   and group 1, deepseek's, 16 kv heads of head dim 128 and group 1, and
   glm4's, 2 kv heads with a group of 16; fused K4 and K4-bs at
   deepseek's 64 experts, gate/up 1408 x 2048 and down 2048 x 1408, w3,
   at the segment heights its traced steps give, each route read off
   the kernels that ran; K3 at seamless-m4t-medium's GELU up projection,
   w4, and qwen2-vl-7b's down projection, w2; K1 and K1-bs at
   seamless's GELU up, N 4096, K 1024, w4, at M 4 and at its encoder's
   64 and 128 frames (the small-M route and the chunk route), and at both
   lm_heads, N 256256, K 1024, w4, and N 152064, K 3584, w2, at M 4; K1
   at qwen2-vl's down projection, K = 18944 (592 words), w2, at M 4 and
   256; K2 at qwen2-vl's decode and whole-prompt prefill, 4 kv heads of
   group 7 (odd, not a power of two), and at seamless's decoder, 16 kv
   heads of group 1, d 64; K6 not causal at seamless's cross-attention
   reads, ``K6_CROSS_CASES``: the decode steps' slot rows, 128 a lane of
   which 128 or 64 are live and the rest at position -1, and the
   whole-prompt prefill) (K3 words at its load shapes and at the
   unfused linear's per-dispatch activation shape, the K1, K4 and K5
   integer cores of every weight, K4's bf16 output and K5's f32/bf16
   dequant bit-exact; K1 and K4 SiLU outputs within 1 bf16 ulp of the
   plain version, K1's GELU within 1 bf16 ulp or 1e-5 absolute; K4's dead rows
   exactly 0 and its live map equal to the analytic one; the unfused
   linear (K3 + K5) equal to the fused one (K1) bit for bit, within 1
   ulp through the SwiGLU; K2, K6 and K7 outputs within 1 bf16 ulp or
   1e-5, and K6 against K2 on the same K/V; K7's fully masked rows 0;
   K7's f32 route, ``float_flash_kernel``, at the same three cases
   with f32 q/K/V, within 1e-5 absolute or 1e-6 relative; both K7
   routes against the plain version of their split at the kernel's own
   ranges, the combine seen to run exactly when the C entry splits T;
   the f32 route counted as its own kernel, ``flash_attention_f32``),
   with its time (CUDA events, L2 flushed before every launch), its
   bound on this card (K7's operations at the bf16 tensor-core rate, its
   f32 route's at 67 TFLOP/s),
   the plain version's time and the yardsticks (K7: one
   ``scaled_dot_product_attention`` call in the same dtype, the same
   function); K1's
   decode cases must run its small-M route and its chunk cases the int8
   tensor-core chunk route of ``csrc/int8_mma.cuh`` (read off the
   kernels that ran, against the library's own ``apmm.small_m_max()``;
   split-K's finish kernel where the grid is thinner than the card), and
   so must K5's (its small-M route, K1's GEMM after a prologue, at M <=
   ``apmm.packed_small_m_max()``, the chunk route above: the route
   printed, read off the kernels that ran); K1's and K5's chunk cases
   print the prologue's and the GEMM's device time apart and the
   ``torch._int_mm`` yardstick times the case's plane-group pairs; K2
   runs at
   ``K2_CASES`` (decode, a prefill chunk, the shape of phase 5's traced
   mixtral decode steps, stablelm's, deepseek's and glm4's decode),
   each held against the plain version of the split plan its C entry
   makes (``ref.paged_attention_split``), the
   split count printed and the combine kernel seen to run exactly when
   it splits; K6 likewise at ``K6_CASES`` (decode, the admitting step's
   bucketed prefill, a 256-slot window), against the plain version of
   its split of the ring's tiles (``ref.kv_cache_attention_split``) and
   the unsplit one; K3 and K6 print their device time beside the Timer's;
   K1-K7 print their time beside
   the time recorded before their redesign (``PREV_MS``); fused K4 also prints
   the route each case took, read off the kernels that ran, which must
   be the one its threshold gives (its decode route up to segments of
   ``moe.fused_route_max()`` rows, its int8 tensor-core chunk route
   above), its prologue's and GEMM's device time apart, and runs at the
   edge of its two routes and at the shapes phase 5's traced MoE steps
   give it (``K4_STEP_SEGS``: a chunk step's 256 tokens, segments of 80
   rows on mixtral and 30 on deepseek; a decode step's 5 lanes bucketed
   to 8, 3 rows on mixtral and 1 on deepseek); the
   ``bitserial``
   variants of K1, K4 and K5 (the b1 tensor-core core) at the same cases
   (K5 also at the width pairs a2w8, a8w8, a1w1, a3w5, odd M/N/K; K5-bs's
   route, its stacked kernel up to ``apmm.packed_bitserial_stack_max()``
   rows and its rows kernel above, read off the kernels that ran with
   their device time):
   integer cores bit-exact to their plain versions and to the fused
   kernels, outputs equal to the fused kernels' bit for bit and within
   their tolerance of plain, K4's live map and dead rows as the fused
   kernel's, each timed beside the fused kernel with the fused row's
   bound (the same function and work) and beside its time before the
   redesign of the bit-serial core (``PREV_MS``), K1's and K4's with the
   prologue's and the GEMM's device time apart (``torch.profiler``), and
   each at the edge of the core's two routes (the stacked route's last
   M or segment height and the rows route's first); K3 at the nested
   checkpoint's w8 load shape, and K1 and K1-bs on one w8 checkpoint's
   plane-prefix views (``NESTED_BITS``, ``NESTED_K1_M``: llama3-8b's dual
   gate/up served at 8, 4 and 2 bits at decode and at a chunk), each
   view seen to reach the C entry uncopied (the full stack's pointer
   plus ``8 - k`` planes), with the bound at k planes; every device
   split leaves the Timer's L2 flush, an f64 fill (``FLUSH_KERNEL``),
   out by its kernel's name;
4. the norm -- ``norm_apply`` on the card at llama3-8b's width and at
   stablelm-3b's layernorm with its bias (d 2560) gives the CPU's bits
   (it reproduces XLA's f32 steps in torch ops), and its time; then full
   width, shallow -- one forward of llama3-8b (depth 2, paged pool and
   fused linear; then a contiguous cache and the unfused linear), of
   mixtral-8x7b (depth 1), of glm4-9b and minicpm-2b (depth 2, paged,
   their own w2 with a kv8 pool; minicpm's tied logits are a bf16
   ``torch.matmul``), of stablelm-3b (depth 2, paged: its own w3, head
   dim 80 with partial rotary 0.25, layernorm with bias) and of
   deepseek-moe-16b (depth 2: the dense layer 0, then a MoE layer; its
   own w3), of mamba2-130m (depth 2, its own w4, the mamba state on slot
   1 of the pool's state slots, tied logits) and of jamba-1.5-large-398b
   (depth 2 with ``attn_every=2``: a mamba + MoE layer, then an attention
   + dense layer, w2, 8 tokens), of seamless-m4t-medium (2 encoder and 2
   decoder layers, its own w4, random frames from the seed, the cross
   caches on slot 1 of the pool's state slots) and of qwen2-vl-7b (depth
   2, its own w2, random patch embeddings and ``(3, B, S)`` positions
   whose axes differ), and of llama3-8b's w8/a8 checkpoint (depth 2)
   served at ``nested_bits`` 8, 4 and 2, on the card, then the same
   forward with
   the parameters moved to the CPU (the plain versions run there because
   the device decides), logits compared within 5% of the largest and,
   for the MoE configs, the share of tokens routed to the same experts,
   and, printed before the bar, each token's top-k agreement between the
   card and the CPU by MoE layer and the smallest router margin (so a
   miss shows whether a route flipped);
5. end to end -- seven main paths, each config at its own weight and
   activation bits with a kv8 cache, random weights from ``--seed``
   quantized on the card (K3 at load), the launch counters zeroed just
   before and read just after each: the full 32-layer llama3-8b (4
   requests, w2), mixtral-8x7b at 4 of its 32 layers (``SERVE_LAYERS``;
   5 requests, one of 4,300 tokens that attends through the rolling
   4,096-token window, w2), deepseek-moe-16b at 8 of its 28 layers
   (``SERVE_LAYERS``; w3: a dense layer 0, then 7 layers of 64 experts, top 6, and a shared
   expert), stablelm-3b at 8 of its 32 layers (w3, head dim 80, MHA,
   layernorm), the full 24-layer mamba2-130m (w4, no KV: the pool is
   state slots only, tied logits) and jamba-1.5-large-398b's first
   hybrid group, layers 0-7 of 72 (w2: 7 mamba layers, attention at
   layer 4, MoE at every other), the last four with llama's prompts,
   each served by ``Engine(paged=True, block_size=16, chunk_tokens=256)``
   with the fused linear, where every forward dispatch launches K1 6
   times a layer (mixtral 4; mamba2 2, the in and out projections) and
   once more (the lm_head; not mamba2's, whose tied logits are a bf16
   matmul), jamba 27 times, K2 once an attention layer and K4 twice a
   MoE layer, and exactly the K1 launches whose M is at most
   ``apmm.small_m_max()`` take its small-M route (a stateful stack's
   mixed step is one decode dispatch plus one B=1 dispatch a chunk lane;
   it never hits the prefix cache); then
   seamless-m4t-medium at full depth (12 encoder and 12 decoder layers,
   w4; its cross-K/V in the pool's state slots) and qwen2-vl-7b at 4 of
   its 28 layers (``SERVE_LAYERS``; w2, M-RoPE), each served by
   ``Engine(paged=True, block_size=16, chunk_tokens=256)``, which drops
   ``chunk_tokens`` for these families (whole-prompt prefill): a
   seamless prefill dispatch launches K1 194 times (the frontend and
   the encoder's 72 at M = the frames, the decoder's cross K/V
   projections at M = the frames, 96 at M = the prompt, the lm_head), a
   decode dispatch 97 (no encoder, no cross K/V projection), and each
   K2 and K6 once a decoder layer; qwen2-vl K1 6 times a layer and once
   more, K2 once a layer; neither hits the prefix cache, seamless
   drains its slots, and it fails if phase 3's ``K6_PATH_STEP`` case is
   not among its decode steps' K6 shapes; then
   llama3-8b at ``CONTIGUOUS_LAYERS`` (4) of its 32 layers served by
   ``Engine(paged=False, n_slots=4, max_len=1024)`` with the unfused
   linear (``llama3-8b-contiguous-unfused``), where every dispatch
   launches K5 and K3 7 times a layer and once more (the lm_head) and K6
   once a layer, and K1, K2, K4 never; each path is followed by its
   bit-serial twin (``QuantConfig(variant="bitserial")``: the same
   weights, prompts and engine; a paged twin serves the fused path's own
   quantized weights, so it launches K3 no time), whose dispatches
   launch the bitserial kernels as often as the twin launched the fused
   ones (``apmm.BITSERIAL_LAUNCHES``,
   ``apmm.PACKED_BITSERIAL_LAUNCHES``, ``moe.BITSERIAL_LAUNCHES``), the
   fused kernels never, and whose greedy tokens equal the twin's, all of
   them; each path profiles one chunk step (contiguous: one admitting
   step) and three decode steps (device time by kernel, idle share); the
   paged paths print K2's shapes in those steps and the ranges it splits
   each into, and mixtral and jamba fail if phase 3's ``K2_STEP`` case
   is not among their decode steps' shapes; the contiguous paths print K6's shapes
   in the traced admitting and decode steps and the ranges of ring tiles
   it splits each into, and fail if phase 3's ``K6_STEP`` case is not
   among the decode steps' shapes, and print K5's device ms and launches
   by kernel in the traced admitting step and decode steps; the
   contiguous fused path counts K5's
   small-M launches (decode) beside its chunk-route launches (prefill); the
   MoE paths print K4's live rows against its capacity rows and its
   segment heights in both, and fail if phase 3's case for that step
   (``K4_STEP_SEGS``) is not among those heights; after llama3-8b's
   pair, llama3-8b-nested and its twin (``serve_phase(precisions=)``,
   ``NESTED_PATH``): one w8/a8 checkpoint at full depth, requests at
   ``Request(precision=)`` 8, 4 and 2 and two late prefix-sharing ones
   at 8 and 4, 16 tokens each; one dispatch per width among a forward's
   lanes, K1 193 and K2 32 times each, every K1 launch on the w8
   stacks' top k planes in place (k the dispatch's width), per-width
   ``repro_engine_precision_total``, exactly one prefix hit (the 8-bit
   late request's: the index is salted by width), one traced decode
   dispatch per width (wall, busy, K1's device ms);
6. training -- minicpm-2b (``TRAIN_ARCH``, the reference's WSD model)
   at full width and 2 layers: one gradient step on the card against
   the CPU from the same parameters and batch (the loss, the gradient
   norm and every leaf's gradient within ``TRAIN_*_TOL``), and a restart
   on the card (int8 moments: 4 steps straight against 2, a synchronous
   checkpoint, a fresh ``Trainer`` restored from it and 2 more; the
   losses and the final state bit-identical; the checkpoints deleted);
   then minicpm-2b at full width and depth trains 8 steps (seq 512,
   batch 4, WSD with warmup 2 and peak lr 1e-3, f32 moments): each
   step's loss, the median step time, ``max_memory_allocated`` and one
   profiled step; every loss finite, the last below the first, and no
   kernel of K1-K7 launched (the reference trains on the float path:
   its attention, MoE experts and linears are XLA ops, not Pallas
   kernels).  The VLM and the enc-dec model (``FAMILY_TRAIN``):
   qwen2-vl-7b at full width and 2 layers, and seamless-m4t-medium with
   2 encoder and 2 decoder layers, one gradient step on the card against
   the CPU from the same parameters and a ``launch.specs.make_batch``
   train batch (M-RoPE ``(3, B, S)`` positions and patch embeddings;
   frames), held to ``FAMILY_*_TOL`` with a bf16-logsumexp control that
   must miss one of them; then qwen2-vl-7b at 4 of its 28 layers and
   seamless-m4t-medium at full depth (12 + 12) train a few steps on
   ``make_batch`` batches: every loss finite, the last below the first,
   the median step time, ``max_memory_allocated``, no K1-K7 launch;
7. distributed, at world size 1 over NCCL (``init_process_group`` with
   an in-process store, a ``(data, model)`` mesh of shape (1, 1) on the
   card): ``sharding.sharded_step`` equal to the plain step bit for bit
   (minicpm-2b at full width and 2 layers), ``compressed_psum``'s codes
   and result equal to the CPU's on the same gradients, a checkpoint
   restored onto the card mesh bit for bit, and ``pipeline_apply`` at one
   stage against the sequential result; each check's time printed;
   then the serve step's three: (a) ``sharding.sharded_serve_step`` on
   the (1, 1) mesh, llama3-8b at full width and ``SERVE_DIST_LAYERS``
   layers, w2/a8/kv8, a 4 x 128 prefill and 4 greedy decode steps, every
   step's logits and every cache leaf equal to the plain
   ``prefill_step`` / ``serve_step``'s bit for bit (a main path: the
   launch counters zeroed just before it, K1 and K6 must launch); (b)
   the row product's card route at llama3-8b's ``w_down`` shape (N 4096,
   K 14336, w2/a8, +residual) at M 4 and 256, fused and bitserial: the K
   words cut ``ROW_SPLIT`` ways, 16 raw K5 products summed in int32, then
   the shared epilogue, equal to K1 on the whole weight bit for bit; (c)
   K6's lse route at the "decode" case: ``o`` with the lse equal to
   ``o`` without it, the ring's two halves combined within 1 bf16 ulp or
   1e-5 of the unsplit output, K6's time with and without the lse (run
   with phase 3: once an NCCL group has come and gone, the profiler has
   returned empty traces of K6 five times in a row);
8. the examples and the dry run: (a) each ``examples/torch_*.py`` in a
   subprocess on the card at small arguments (``EXAMPLES``): exit 0, its
   launch counters printed; K1, K2, K3 and K5 must each launch in one of
   them (``torch_quickstart.py`` holds K5's bit-serial and fused products
   to the exact integer product and K3's words to its plain version, on
   the card); (b) the dry run's cell functions against the caching
   allocator at world size 1: a subprocess traces minicpm-2b training (2
   layers, 2 x 128 tokens, int8 moments) and llama3-8b decode (w2/a8/kv8,
   caches of 4 x 1024) on meta over a one-rank fake group; the same
   functions then run on the card over a one-rank NCCL group, and the dry
   run's ``argument_bytes`` must equal ``torch.cuda.memory_allocated()``'s
   growth up to the allocator's rounding (``ALLOC_ROUND`` a tensor); its
   ``peak_bytes`` is printed beside ``max_memory_allocated()`` of one
   step; (c) one production cell in a subprocess, ``python -m
   repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh
   single``, which must end ``ok`` with at most 1 GiB of weights
   gathered at once, at most 3.5e14 FLOPs a rank and a peak under the
   card's 80 GB (the sharded step's tensor-parallel compute);
9. the launch counts of each path, the JSON kernels line (one entry per
   path and kernel of that path, ``launches`` that path's own count, the
   other numbers those of the phase-3 case at that path's own shape,
   named in ``case`` (``PATH_CASES``; the kernel's shared case where
   the path has none); K7's two routes, on no path, with their phase-3
   launches), the
   ``nvidia-smi`` line and, last, the JSON device line.

It imports nothing of JAX and nothing of the reference package.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# published H100 SXM peaks (NVIDIA data sheet, dense), used for bounds
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989.4e12     # dense tensor-core rate (K7's bf16 route)

# (tokens, segment height) of each MoE path's K4 calls in phase 5's traced
# steps (layers.moe_apply: G = 1, capacity ceil(top_k T 1.25 / E) rows): a
# chunk step runs one 256-token chunk; a decode step runs the (B, 1) batch
# of the 5 requests bucketed to 8 lanes (Engine.max_batch = 2 n_slots),
# the pad lanes routed too.  mixtral: top 2 of 8 experts; deepseek-moe-16b:
# top 6 of 64.  Phase 3 times K4 at these shapes; phase 5 fails if its
# traced steps gave K4 no such call.
# jamba-1.5-large-398b: top 2 of 16, llama's 4 requests (a decode step
# of 4 lanes); its chunk lane runs alone at B = 1 (a stateful stack's
# mixed step splits), so a chunk is still 256 tokens.
K4_STEP_SEGS = {"mixtral-8x7b": {"chunk": (256, 80), "decode": (8, 3)},
                "deepseek-moe-16b": {"chunk": (256, 30), "decode": (8, 1)},
                "jamba-1.5-large-398b": {"chunk": (256, 40),
                                         "decode": (4, 1)}}

# K2's cases in phase 3: (name, tokens of each lane -- None: a pad lane on
# an all-null table --, query tokens a lane, table width NB, window, the
# heads: (kv heads H, GQA group, head dim d)).  llama3-8b's and
# mixtral-8x7b's heads are (8, 4, 128).  "mixtral decode window" is the
# shape of phase 5's traced mixtral decode steps: the 5 requests bucketed
# to 8 lanes, the 4,300-token one past its 4,096-token window (its
# out-of-window blocks reclaimed), NB the engine's table width (4352 //
# 16: the long lane's ~257 blocks bucket to 512, capped there); phase 5
# fails if those steps gave K2 no call of its (B, Gq, NB, window).
# "stablelm decode": stablelm-3b's 32 kv heads at head dim 80 (three
# packed words: the kernel's 4-byte staging) and group 1; "deepseek
# decode": deepseek-moe-16b's 16 kv heads at head dim 128 and group 1;
# "glm4 decode": glm4-9b's 2 kv heads with a group of 16.  "jamba
# decode": jamba-1.5-large-398b's 8 kv heads with a group of 8 at the shape
# of phase 5's traced jamba decode steps (its 4 requests, NB the engine's
# 64); phase 5 fails if those steps gave K2 no such call.
K2_CASES = (("decode", (600,) * 4, 1, 64, None, (8, 4, 128)),
            ("chunk", (600,), 256, 64, None, (8, 4, 128)),
            ("mixtral decode window", (609, 109, 309, 4309, 209, None, None,
                                       None), 1, 272, 4096, (8, 4, 128)),
            ("stablelm decode", (600,) * 4, 1, 64, None, (32, 1, 80)),
            ("deepseek decode", (600,) * 4, 1, 64, None, (16, 1, 128)),
            ("glm4 decode", (600,) * 4, 1, 64, None, (2, 16, 128)),
            ("jamba decode", (640, 140, 340, 240), 1, 64, None,
             (8, 8, 128)),
            ("qwen2-vl decode", (640, 140, 340, 240), 1, 64, None,
             (4, 7, 128)),
            ("qwen2-vl prefill", (600,), 1024, 64, None, (4, 7, 128)),
            ("seamless decode", (640, 140, 340, 240), 1, 64, None,
             (16, 1, 64)))
# "qwen2-vl decode" and "seamless decode": the shapes of phase 5's traced
# decode steps of those paths (llama's 4 requests, NB the engine's 64);
# qwen2-vl's 4 kv heads have a group of 7, seamless's 16 a group of 1 at
# head dim 64.  "qwen2-vl prefill": the 600-token prompt's whole-prompt
# prefill, bucketed to 1024 query rows (600 live, 424 pads at -1), Gq =
# 7 x 1024
K2_STEP = {"mixtral-8x7b": "mixtral decode window",
           "jamba-1.5-large-398b": "jamba decode",
           "qwen2-vl-7b": "qwen2-vl decode",
           "seamless-m4t-medium": "seamless decode"}

# K6's cases in phase 3 (llama3-8b's shapes: 8 kv heads, GQA group 4, d
# 128, kv8): (name, the ring of ``_ring_case``, window).  "decode" is the
# shape of phase 5's traced contiguous decode steps (the 4 slots' rings,
# T = max_len 1024); phase 5 fails if those steps gave K6 no call of its
# (B, H, Sq, T, window).  "prefill" is the admitting step's bucketed
# prompt (B = 1, 4 x 1024 query rows: a grid that fills the card).
K6_CASES = (("decode", dict(b=4, t=1024, live=632, s=1), None),
            ("prefill", dict(b=1, t=1024, live=600, s=1024, prefill=True),
             None),
            ("decode window 256", dict(b=4, t=1024, live=632, s=1), 256))
K6_STEP = "decode"

# K6 at seamless-m4t-medium's cross-attention reads (16 heads, MHA, d 64,
# kv8, not causal, every query at position 0): (name, each lane's live
# encoder rows, query rows a lane, the rows T a lane holds).  "seamless
# cross decode" is the shape of phase 5's traced seamless decode steps:
# the 4 requests' slot rows, T = enc_len(cfg, 1024) = 128, each lane's
# enc_len of its bucketed prompt live (600 -> 1024 -> 128; 100, 300 and
# 200 -> 64) and the rest at position -1; phase 5 fails if those steps
# gave K6 no call of its (B, H, Sq, T).  "seamless cross prefill": the
# 600-token prompt's whole-prompt prefill, its 1024 bucketed query rows
# over the 128 rows its frames give.
K6_CROSS_CASES = (("seamless cross decode", (128, 64, 64, 64), 1, 128),
                  ("seamless cross prefill", (128,), 1024, 128))
K6_PATH_STEP = {"seamless-m4t-medium": "seamless cross decode"}

# the depths of phase 5's cut pairs, each of its config's layers, so that
# the whole run keeps inside its time budget: llama3-8b's contiguous pair
# (4 of 32; 8 until the nested pair came) and mixtral-8x7b (4 of 32; 16
# until phases 6 and 7 came, 8 until the nested pair came),
# deepseek-moe-16b (8 of 28: the dense layer 0 and 7 MoE layers) and
# stablelm-3b (8 of 32), whose widths phases 3 and 4 cover;
# jamba-1.5-large-398b serves one hybrid group (8 of 72 layers: 7 mamba
# and 1 attention, MoE at every other); qwen2-vl-7b serves 4 of its 28
# alike layers.  llama3-8b, mamba2-130m and seamless-m4t-medium (12 + 12)
# serve at full depth.
CONTIGUOUS_LAYERS = 4
SERVE_LAYERS = {"mixtral-8x7b": 4, "deepseek-moe-16b": 8, "stablelm-3b": 8,
                "jamba-1.5-large-398b": 8, "qwen2-vl-7b": 4}

# phase 5's nested-precision path, llama3-8b-nested (``serve_phase``'s
# arguments): one w8/a8 checkpoint (kv8 pool) at full width and depth (32
# layers; K1 6 a layer + the lm_head and K2 one a layer each dispatch, K3
# 7 a layer + the lm_head at load), llama's prompts at
# ``Request(precision=)`` 8, 4 and 2, the first carrying the 128-token
# prefix; once it has emitted, two 200-token requests with that prefix at
# 8 and 4 bits.  16 greedy tokens each (a mixed step makes one dispatch
# per width, so a step costs about three of llama's)
NESTED_PATH = dict(per_dispatch={"apmm_fused_linear": 193,
                                 "paged_attention": 32},
                   n_pack=225, w_bits=8, prompt_lens=(600, 100, 300),
                   late=(200, 200), precisions=(8, 4, 2, 8, 4),
                   new_tokens=16, prefix=128, max_len=1024, n_blocks=257)

# the phase-3 case whose numbers (ms, bound, plain, error) a path's
# entry in the kernels line carries, by path and kernel (its bitserial
# kernel too): the case at that path's own shape; a kernel a path does
# not name here carries its ``SHARED_CASES`` case (llama3-8b's shape)
SHARED_CASES = {"quantize_pack_rows": "load",
                "apmm_fused_linear": "decode gate/up",
                "paged_attention": "decode",
                "moe_expert_linear": "decode gate/up",
                "apmm_packed": "decode gate",
                "flash_attention_quantized": "decode",
                "flash_attention": "decode"}
PATH_CASES = {
    "mixtral-8x7b": {"apmm_fused_linear": "decode q",
                     "paged_attention": "mixtral decode window",
                     "moe_expert_linear": "decode step gate/up"},
    "deepseek-moe-16b": {"quantize_pack_rows": "deepseek load",
                         "apmm_fused_linear": "deepseek dense down",
                         "paged_attention": "deepseek decode",
                         "moe_expert_linear":
                             "deepseek decode step gate/up"},
    "stablelm-3b": {"quantize_pack_rows": "stablelm load",
                    "apmm_fused_linear": "stablelm decode gate/up",
                    "paged_attention": "stablelm decode"},
    "mamba2-130m": {"quantize_pack_rows": "mamba2 load",
                    "apmm_fused_linear": "mamba2 decode in_proj"},
    "jamba-1.5-large-398b": {"quantize_pack_rows": "jamba load",
                             "apmm_fused_linear": "jamba decode in_proj",
                             "paged_attention": "jamba decode",
                             "moe_expert_linear":
                                 "jamba decode step gate/up"},
    "qwen2-vl-7b": {"quantize_pack_rows": "qwen2-vl load",
                    "apmm_fused_linear": "qwen2-vl decode down",
                    "paged_attention": "qwen2-vl decode"},
    "llama3-8b-sharded-serve": {"flash_attention_quantized": "decode lse"},
    "llama3-8b-nested": {"quantize_pack_rows": "nested load",
                         "apmm_fused_linear": "nested decode gate/up k4"},
    "seamless-m4t-medium": {"quantize_pack_rows": "seamless load",
                            "apmm_fused_linear": "seamless decode up",
                            "paged_attention": "seamless decode",
                            "flash_attention_quantized":
                                "seamless cross decode"},
}

# the redesigned kernels' times before the redesign, as PERF.md section 6
# records them (this Timer, NVIDIA H100 80GB HBM3 at 700 W); None: not
# recorded
PREV_MS = {
    "K1 decode q": 0.2685, "K1 decode gate/up": 0.8167,
    "K1 decode down": None, "K1 decode lm_head": 3.5601,
    "K1 chunk q": 2.8369, "K1 chunk gate/up": 13.7831, "K1 chunk down": 9.6811,
    "K1 odd": None,
    # K1's dp4a tile (every M above the small-M route) before the chunk
    # route's redesign: PERF.md section 6's rows at these shapes
    "K1 deepseek chunk dense down": 1.1038, "K1 mamba2 chunk in_proj": 0.1856,
    "K1 jamba chunk in_proj": 11.8417, "K1 seamless encoder up 128": 0.1385,
    "K1 qwen2-vl chunk down": 3.5290,
    "K7 decode": 0.8197, "K7 prefill": 1.4612, "K7 decode window 256": 0.4318,
    # K7's f32 route before its redesign (the SIMT kernel: a block per
    # 16-row q-tile and head, T never split): PERF.md section 6's row
    "K7 f32 decode": 0.7494, "K7 f32 prefill": 1.3439,
    "K7 f32 decode window 256": 0.3886,
    # fused K4's first design (a dp4a SIMT tile per segment): PERF.md's K4
    # row, and the same-call times beside the redesigned bitserial core
    "K4 decode gate/up": 0.7382, "K4 decode down": None,
    "K4 chunk gate/up": 12.7678, "K4 G=32 down": 63.2758,
    # the bitserial kernels on the earlier b1 core (.xor.popc, X re-packed in
    # every column block), before the .and / stacked / pipelined redesign
    "K1-bs decode q": 0.2025, "K1-bs decode gate/up": 0.2387,
    "K1-bs decode down": 0.5510, "K1-bs decode lm_head": 1.2413,
    "K1-bs chunk q": 3.5084, "K1-bs chunk gate/up": 14.0798,
    "K1-bs chunk down": 11.9667,
    "K4-bs decode gate/up": 0.9255, "K4-bs decode down": 0.8463,
    "K4-bs chunk gate/up": 34.0367, "K4-bs G=32 down": 123.8199,
    # K5-bs on the rows route alone (16 x 64 tiles up to M = 32, 64 x 64
    # above), before its stacked route: the parent's medians in one
    # tools/bitserial_ab.py call beside it (PERF.md section 6)
    "K5-bs decode q": 0.0896, "K5-bs decode gate": 0.0939,
    "K5-bs decode down": 0.1972, "K5-bs decode lm_head": 0.6482,
    "K5-bs chunk q": 0.5607, "K5-bs chunk gate": 1.8051,
    "K5-bs odd, unequal Kw": 0.0500, "K5-bs odd a2w8": 0.0750,
    "K5-bs odd a8w8": 0.1127, "K5-bs odd a1w1": 0.0538,
    "K5-bs odd a3w5": 0.0795, "K5-bs stack edge gate": 0.2037,
    "K5-bs rows edge gate": 0.1642,
    # K2 (one block per q-tile, head and request walking the whole table)
    # and fused K5 (the dp4a tile at every M) before their redesign: the
    # mean of two runs of tools/k2_k5_times.py on that code at these cases
    # (K5's chunk cases: the dp4a tile's, which the chunk route replaced)
    "K2 decode": 0.2648, "K2 chunk": 0.8842, "K2 mixtral decode window": 1.583,
    "K5 decode q": 0.1749, "K5 decode gate": 0.1985, "K5 decode down": 0.5153,
    "K5 decode lm_head": 0.6501, "K5 chunk q": 1.1442, "K5 chunk gate": 3.7087,
    "K5 odd, unequal Kw": 0.0748, "K5 odd a2w8": 0.0791, "K5 odd a8w8": 0.0855,
    "K5 odd a1w1": 0.0476, "K5 odd a3w5": 0.0544,
    # K3 (a thread per output word) and K6 (a block per q-tile, head and
    # request walking the whole ring) before their redesign: the mean of
    # two runs of tools/k3_k6_times.py on that code at these cases
    "K3 load": 0.5511, "K3 decode activations": 0.0584,
    "K6 decode": 0.2247, "K6 prefill": 1.2033, "K6 decode window 256": 0.1581,
}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: " + out.stderr.strip()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

# the Timer's L2 flush is a 64 MiB f64 fill, whose kernel no measured
# function launches: ``device_split`` leaves it out by this name
FLUSH_KERNEL = "FillFunctor<double>"


class Timer:
    """Median CUDA-event time of ``fn`` with L2 flushed before each
    launch (the serving path reads every weight cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(8 << 20, dtype=torch.float64, device="cuda")

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        return times[len(times) // 2]


def bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in units in the last place:
    the ordinal distance of their bit patterns (+0 and -0 coincide)."""
    import torch

    def ordinal(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordinal(a) - ordinal(b)).abs()


def device_us(ev) -> float:
    """A profiler event's own device time, µs (the attribute's name
    differs between torch versions)."""
    dev = getattr(ev, "self_device_time_total", None)
    return getattr(ev, "self_cuda_time_total", 0.0) if dev is None else dev


# the profiler has lost the first events of a window and the last ones
# before it closed (on its own or in bursts of several windows):
# ``device_split`` and ``profile_steps`` pause this long, s, after
# opening a window and before closing it, and ``device_split`` opens its
# with a lead-in fill it waits for and pauses a second before taking a
# lossy trace again
PROFILER_PAUSE_S = 0.02
# what the profiler lost this run: a ``device_split`` window's lead-in
# fill, a ``device_split`` trace taken again (a kernel's launches or a
# flush fill short), a ``profile_steps`` trace with no device time (its
# caller traces a later step); printed at the end of the run
PROFILER_DROPS = {"lead_in": 0, "device_split": 0, "profile_steps": 0}


def device_split(torch, timer, fn, iters: int = 10, tries: int = 5) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by name
    (``torch.profiler``; L2 flushed before each call, as the Timer does;
    the flush's own fill, ``FLUSH_KERNEL``, left out by name).  The
    window opens with one more fill, which the profiler may miss.  Every
    call launches the same kernels, so a trace holding other than
    ``iters`` or ``iters + 1`` fills, or a kernel whose launches are not
    a multiple of ``iters``, lost events: it is taken again, ``tries``
    times in all, and then fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            timer.flush.zero_()
            torch.cuda.synchronize()
            time.sleep(PROFILER_PAUSE_S)
            for _ in range(iters):
                timer.flush.zero_()
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILER_PAUSE_S)
        out, short, fills = {}, {}, 0
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            if FLUSH_KERNEL in ev.key:
                fills += ev.count
                continue
            out[ev.key] = device_us(ev) / iters / 1e3
            if ev.count % iters:
                short[kernel_name(ev.key)] = ev.count
        if fills in (iters, iters + 1) and not short:
            PROFILER_DROPS["lead_in"] += fills == iters
            return out
        PROFILER_DROPS["device_split"] += 1
        print(f"device_split: the trace of {iters} calls held {fills} flush "
              f"fills ({FLUSH_KERNEL}, the lead-in's included) and launches "
              f"{short or 'whole'}: taken again", flush=True)
    raise AssertionError(f"device_split: {tries} traces of {iters} calls "
                         f"each lost events")


def kernel_name(key: str) -> str:
    """A kernel's own name in the profiler's demangled signature."""
    m = re.search(r"(\w+)[<(]", key)
    return m.group(1) if m else key


def kernel_names(split: dict) -> list:
    """The kernels' own names among a ``device_split``'s keys, sorted."""
    return sorted({kernel_name(key) for key in split})


def traced_split(torch, timer, fn, names) -> dict:
    """A ``device_split`` of ``fn`` that caught one of the kernels
    ``names``; a trace that caught none is taken again, twice at most."""
    for _ in range(3):
        split = device_split(torch, timer, fn)
        if set(names) & set(kernel_names(split)):
            return split
    raise AssertionError(f"the profiler caught none of {names}")


def split_line(split: dict) -> str:
    """A ``device_split`` as "name ms, ..."."""
    return ", ".join(f"{kernel_name(k)} {v:.4f}" for k, v in split.items())


def bitserial_split(torch, timer, fn, split=None) -> str:
    """The prologue's (bitserial: X packed once, with its SU clear; fused
    K4: the live rows quantized once; fused K1 and K5: X quantized, or A's
    planes converted, once, and split-K's clear) and the GEMM's (split-K:
    with its finish) device time per
    call, apart: the breakdown ``ncu`` would give (``split``: a
    ``device_split`` of ``fn`` already taken)."""
    if split is None:
        split = device_split(torch, timer, fn)
    pro = sum(v for k, v in split.items()
              if "pack_x" in k or "emset" in k or "prologue" in k
              or "quantize_x" in k or "packed_to_xq" in k)
    gemm = sum(v for k, v in split.items()
               if "bitserial_" in k or "fused_decode" in k
               or "fused_chunk" in k or "dense_chunk" in k
               or "split_finish" in k or "gemm_kernel" in k)
    rest = sum(split.values()) - pro - gemm
    return (f"device split: prologue {pro:.4f} ms, GEMM {gemm:.4f} ms"
            + (f", other {rest:.4f} ms" if rest > 0 else ""))


def fused_k4_routes(torch, timer, fn):
    """The routes fused K4 took in ``fn``, read off the kernels that ran
    (``moe_fused_decode_kernel``, ``moe_fused_chunk_kernel``), with the
    ``device_split``."""
    kernels = {route: f"moe_fused_{route}_kernel"
               for route in ("decode", "chunk")}
    split = traced_split(torch, timer, fn, list(kernels.values()))
    ran = kernel_names(split)
    return {route for route, k in kernels.items() if k in ran}, split


def bound_ms(n_bytes: float, n_ops: float, ops_rate: float):
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / ops_rate
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def versus_prev(key: str, b_ms: float) -> str:
    """The time recorded before the redesign, with its share of the
    bound."""
    prev = PREV_MS.get(key)
    if prev is None:
        return "before the redesign not recorded"
    return (f"before the redesign {prev:.4f} ms ({100 * b_ms / prev:.1f}% "
            f"of bound)")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# K3's cases: (name, rows, K, bits, pad bit): the weights' pack at load,
# and the unfused linear's per-dispatch activation pack at decode (M = 4,
# a8); both f32 (ops.quantize_rows hands K3 x.float())
K3_CASES = (("load", 14336, 4096, 2, 1),
            ("decode activations", 4, 4096, 8, 0),
            # one deepseek-moe-16b expert's gate (1408 x 2048) and
            # stablelm-3b's gate (6912 x 2560), each at its own w3
            ("deepseek load", 1408, 2048, 3, 1),
            ("stablelm load", 6912, 2560, 3, 1),
            # mamba2-130m's in_proj (3352 x 768) at its own w4, and one
            # jamba-1.5-large-398b expert's gate (24576 x 8192), w2
            ("mamba2 load", 3352, 768, 4, 1),
            ("jamba load", 24576, 8192, 2, 1),
            # seamless-m4t-medium's GELU up (4096 x 1024) at its own w4,
            # and qwen2-vl-7b's down projection (3584 x 18944), w2
            ("seamless load", 4096, 1024, 4, 1),
            ("qwen2-vl load", 3584, 18944, 2, 1),
            # the nested checkpoint's pack: llama3-8b's gate at w8, the
            # widest width, once at load (served at 8, 4 and 2 bits)
            ("nested load", 14336, 4096, 8, 1))


def k3_phase(torch, timer, rng_seed, results):
    from repro_torch.core import bipolar
    from repro_torch.kernels import pack, ref
    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    for name, r, k, n_bits, pad_bit in K3_CASES:
        x = torch.randn((r, k), generator=g, device="cuda")
        scale = bipolar.absmax_scale(x, n_bits, axis=-1)
        got = pack.quantize_pack_rows(x, scale, n_bits=n_bits,
                                      pad_bit=pad_bit)
        torch.cuda.synchronize()
        want = ref.quantize_pack_rows(x, scale, n_bits=n_bits,
                                      pad_bit=pad_bit)
        err = float((got.long() - want.long()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"K3 {name}: words differ from the plain "
                                 f"version")
        def run():
            return pack.quantize_pack_rows(x, scale, n_bits=n_bits,
                                           pad_bit=pad_bit)

        ms = timer(run, iters=20)
        split = traced_split(torch, timer, run, ["quantize_pack_rows_kernel"])
        plain = timer(lambda: ref.quantize_pack_rows(
            x, scale, n_bits=n_bits, pad_bit=pad_bit), iters=3, warmup=1)
        kw = bipolar.packed_words(k)
        b_ms, b_by = bound_ms(r * k * x.element_size() + r * 4
                              + n_bits * r * kw * 4, 0, INT8_OPS_PER_S)
        dev = sum(split.values())
        print(f"K3 quantize_pack_rows {name} {r}x{k} f32 w{n_bits} pad "
              f"{pad_bit}: words equal; {ms:.4f} ms, device {dev:.4f} ms "
              f"(bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.1f}% of "
              f"bound, device {100 * b_ms / dev:.1f}%; "
              f"{versus_prev('K3 ' + name, b_ms)}), plain {plain:.4f} ms",
              flush=True)
        results["quantize_pack_rows", name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=None)
        del x, got, want


# K1's bf16 output against its plain version, by epilogue activation:
# act=none is bit-exact; SiLU differs only by expf, rounded once to bf16
# at the end: at most 1 ulp an element; GELU's tanh too, except where
# 1 + tanh nears 0 (the output is within ~1e-6 of 0 and the ulps there
# are tiny): 1 ulp or 1e-5 absolute, the attention kernels' rule
ACT_TOL = {"none": "0", "silu": "1", "gelu": "1 or 1e-5"}


def _act_check(label, act, got, want):
    """Hold K1's bf16 output ``got`` to ``want`` by ``ACT_TOL``; returns
    (max |err|, max ulps beyond 1e-5 for gelu, else max ulps)."""
    err = (got.float() - want.float()).abs().max().item()
    if act == "gelu":
        ok, err, ulps = _within(got, want)
    else:
        ulps = int(bf16_ulps(got, want).max())
        ok = ulps <= (0 if act == "none" else 1)
    if not ok:
        raise AssertionError(f"{label} act={act}: bf16 output {ulps} ulps "
                             f"from plain (max |err| {err}; tol "
                             f"{ACT_TOL[act]})")
    return err, ulps


def _fused_route(torch, timer, label, fn, m, threshold, prologue):
    """The route a fused K1 or K5 call ``fn`` at M = ``m`` took, read off
    the kernels that ran: the small-M route (``small_m.cuh``'s
    ``gemm_kernel``) at M <= ``threshold``, the chunk route
    (``int8_mma.cuh``'s ``dense_chunk_kernel``, and ``split_finish_kernel``
    where it splits K) above, each after its ``prologue`` kernel; returns
    (route, the ``device_split``)."""
    split = traced_split(torch, timer, fn,
                         ["gemm_kernel", "dense_chunk_kernel"])
    ran = kernel_names(split)
    route = "small-M" if "gemm_kernel" in ran else "chunk"
    if route != ("small-M" if m <= threshold else "chunk") or \
            prologue not in ran or (route == "chunk" and "gemm_kernel" in ran):
        raise AssertionError(f"{label} M={m}: kernels {ran} ran, not the "
                             f"route its threshold {threshold} gives")
    if "split_finish_kernel" in ran:
        route += " split-K"
    return route, split


def _k1_case(torch, timer, g, name, m, n, k, *, dual=False, residual=False,
             act="none", w_bits=2, a_bits=8, cache=None, weights=None,
             yardsticks=True):
    """K1 and K1-bs at one phase-3 case, on new random weights packed at
    ``w_bits`` (``cache``: reused by shape), or on ``weights``, a (w, w2)
    pair given (a nested checkpoint's plane-prefix views); the
    yardsticks are left out where an earlier case timed them at this
    shape."""
    from repro_torch.core import bipolar
    from repro_torch.kernels import apmm, ops, ref
    key = (n, k, dual, w_bits)
    if weights is not None:
        w, w2 = weights
        w_bits = w.n_bits
    elif cache is not None and key in cache:
        w, w2 = cache[key]
    else:
        w = ops.pack_weight(torch.randn((n, k), generator=g, device="cuda"),
                            w_bits)
        w2 = ops.pack_weight(torch.randn((n, k), generator=g,
                                         device="cuda"), w_bits) \
            if dual else None
        if cache is not None:
            cache[key] = (w, w2)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    res = torch.randn((m, n), generator=g, device="cuda").to(
        torch.bfloat16) if residual else None
    a_s = bipolar.absmax_scale(x, a_bits, axis=-1).float()
    # the integer core of each weight: act=none, f32 out -- bit-exact
    for wt in (w, w2) if dual else (w,):
        core = apmm.apmm_fused_linear(x, a_s, wt, a_bits=a_bits,
                                      out_dtype=torch.float32)
        torch.cuda.synchronize()
        core_ref = ref.ap_linear_fused_ref(x, a_s, wt, a_bits=a_bits,
                                           out_dtype=torch.float32)
        if not torch.equal(core, core_ref):
            raise AssertionError(f"K1 {name}: integer core differs from "
                                 f"plain")
        del core, core_ref

    def run():
        return apmm.apmm_fused_linear(x, a_s, w, w2=w2, residual=res,
                                      a_bits=a_bits, act=act,
                                      out_dtype=torch.bfloat16)

    def run_plain():
        return ref.ap_linear_fused_ref(x, a_s, w, w2=w2, residual=res,
                                       a_bits=a_bits, act=act,
                                       out_dtype=torch.bfloat16)

    small = apmm.SMALL_M_LAUNCHES
    got, want = run(), run_plain()
    if apmm.SMALL_M_LAUNCHES - small != int(m <= apmm.small_m_max()):
        raise AssertionError(f"K1 {name}: small-M launch counter")
    err, ulps = _act_check(f"K1 {name}", act, got, want)
    route, split = _fused_route(torch, timer, f"K1 {name}", run, m,
                                apmm.small_m_max(), "quantize_x_kernel")
    ms = timer(run, iters=10)
    plain = timer(run_plain, iters=2, warmup=1)
    nw = 2 if dual else 1
    kw = w.packed.shape[-1]
    groups = len(ref.plane_groups(a_bits)) * len(ref.plane_groups(w_bits))
    n_bytes = m * k * 2 + m * 4 + nw * (w_bits * n * kw * 4 + n * 4) \
        + (m * n * 2 if residual else 0) + m * n * 2
    n_ops = nw * groups * 2 * m * n * k
    b_ms, b_by = bound_ms(n_bytes, n_ops, INT8_OPS_PER_S)
    # the bitserial kernel on the same inputs: its integer cores equal the
    # plain bitserial version's and the fused kernel's, its output the
    # fused kernel's bit for bit (same epilogue code) and the plain
    # version's within the fused kernel's tolerance; the same bound (the
    # same function and work)
    bs = _k1_bitserial(torch, timer, name, x, a_s, w, w2, res, a_bits, act,
                       got, want, ms, b_ms, b_by)
    yard = ""
    if yardsticks:    # not the same function; the port never calls them
        wb = torch.randn((nw * n, k), generator=g, device="cuda").to(
            torch.bfloat16)
        mm = timer(lambda: torch.matmul(x, wb.T), iters=10)
        mi = max(m, 32)           # torch._int_mm takes M > 16 on the card
        xi = torch.randint(-127, 128, (mi, k), device="cuda",
                           dtype=torch.int8)
        wi = torch.randint(-127, 128, (nw * n, k), device="cuda",
                           dtype=torch.int8)
        im = timer(lambda: torch._int_mm(xi, wi.t()), iters=10)
        del wb, xi, wi
        yard = (f"; yardsticks (paper's cuBLAS/CUTLASS class, not the same "
                f"function): torch.matmul bf16 {mm:.4f} ms, torch._int_mm "
                f"int8 M={mi} {im:.4f} ms, x {groups} group pairs "
                f"{im * groups:.4f} ms")
    print(f"K1 apmm_fused_linear {name} M={m} N={n} K={k} ({kw} words, "
          f"{'16-byte' if kw % 4 == 0 else '4-byte'} weight loads) "
          f"w{w_bits}a{a_bits}"
          f"{' dual' if dual else ''}{' +res' if residual else ''}"
          f" act={act}, {route} route "
          f"({bitserial_split(torch, timer, run, split)}): "
          f"core bit-exact, out max|err| "
          f"{err:.3g}, {ulps} bf16 ulps (tol {ACT_TOL[act]}); "
          f"{ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
          f"{100 * b_ms / ms:.1f}% of bound; "
          f"{versus_prev('K1 ' + name, b_ms)}), plain "
          f"{plain:.4f} ms{yard}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), bs


def _k1_bitserial(torch, timer, name, x, a_s, w, w2, res, a_bits, act,
                  fused_out, plain_fused, fused_ms, b_ms, b_by):
    """K1's bitserial kernel at one phase-3 case (see ``_k1_case``)."""
    from repro_torch.kernels import apmm, ref
    before = (apmm.BITSERIAL_LAUNCHES, apmm.LAUNCHES)
    for wt in (w, w2) if w2 is not None else (w,):
        core = apmm.apmm_fused_linear(x, a_s, wt, a_bits=a_bits,
                                      variant="bitserial",
                                      out_dtype=torch.float32)
        torch.cuda.synchronize()
        core_ref = ref.ap_linear_fused_ref(x, a_s, wt, a_bits=a_bits,
                                           variant="bitserial",
                                           out_dtype=torch.float32)
        fused = apmm.apmm_fused_linear(x, a_s, wt, a_bits=a_bits,
                                       out_dtype=torch.float32)
        if not (torch.equal(core, core_ref) and torch.equal(core, fused)):
            raise AssertionError(f"K1 bitserial {name}: integer core "
                                 f"differs from plain or from fused")
        del core, core_ref, fused

    def run():
        return apmm.apmm_fused_linear(x, a_s, w, w2=w2, residual=res,
                                      a_bits=a_bits, act=act,
                                      variant="bitserial",
                                      out_dtype=torch.bfloat16)

    def run_plain():
        return ref.ap_linear_fused_ref(x, a_s, w, w2=w2, residual=res,
                                       a_bits=a_bits, act=act,
                                       variant="bitserial",
                                       out_dtype=torch.bfloat16)

    got, want = run(), run_plain()
    if not torch.equal(got, fused_out):
        raise AssertionError(f"K1 bitserial {name}: output differs from the "
                             f"fused kernel's")
    if not torch.equal(want, plain_fused):
        raise AssertionError(f"K1 bitserial {name}: plain bitserial differs "
                             f"from plain fused")
    err, ulps = _act_check(f"K1 bitserial {name}", act, got, want)
    if apmm.BITSERIAL_LAUNCHES - before[0] != (3 if w2 is not None else 2) \
            or apmm.LAUNCHES - before[1] != (2 if w2 is not None else 1):
        raise AssertionError(f"K1 bitserial {name}: launch counters")
    ms = timer(run, iters=10)
    plain = timer(run_plain, iters=2, warmup=1)
    m = x.shape[0]
    route = "stacked" if m <= apmm.bitserial_stack_max() else "rows"
    print(f"K1 apmm_fused_linear_bitserial {name} M={m} "
          f"N={w.shape[0]} K={x.shape[1]} act={act}, {route} route: cores "
          f"bit-exact to plain and fused, out equal to the fused kernel's, "
          f"max|err| {err:.3g}, {ulps} bf16 ulps (tol "
          f"{ACT_TOL[act]}); {ms:.4f} ms (bound {b_ms:.4f} ms "
          f"by {b_by}, the fused row's; {100 * b_ms / ms:.1f}% of bound; "
          f"{versus_prev('K1-bs ' + name, b_ms)}; "
          f"{bitserial_split(torch, timer, run)}), fused kernel "
          f"{fused_ms:.4f} ms in this run, plain {plain:.4f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, fused_ms=fused_ms)


# K1's cases in phase 3: (name, M, N, K, options of _k1_case)
K1_CASES = (
    ("decode q", 4, 4096, 4096, {}),
    ("decode gate/up", 4, 14336, 4096, dict(dual=True, act="silu")),
    ("decode down", 4, 4096, 14336, dict(residual=True)),
    ("decode lm_head", 4, 128256, 4096, {}),
    ("chunk q", 1024, 4096, 4096, {}),
    ("chunk gate/up", 1024, 14336, 4096, dict(dual=True, act="silu")),
    ("chunk down", 1024, 4096, 14336, dict(residual=True)),
    ("odd", 5, 1000, 1000, {}),
    # deepseek-moe-16b's dense layer-0 down projection at its own w3:
    # K = 10944 is 342 words, not a multiple of 4 (K1's non-vector
    # weight loads), at decode (small-M route) and at a chunk (chunk
    # route, split-K: 64 blocks of 128 columns)
    ("deepseek dense down", 4, 2048, 10944,
     dict(residual=True, w_bits=3)),
    ("deepseek chunk dense down", 256, 2048, 10944,
     dict(residual=True, w_bits=3)),
    # stablelm-3b's dual gate/up at its own w3, at decode
    ("stablelm decode gate/up", 4, 6912, 2560,
     dict(dual=True, act="silu", w_bits=3)),
    # mamba2-130m's in_proj at its own w4: N 3352 = 52 x 64 + 24, the
    # first path shape whose last 64-column tile is partial (24 live
    # columns), at decode (small-M route) and at a chunk (chunk route); its
    # out_proj (N 768, K 1536) at decode
    ("mamba2 decode in_proj", 4, 3352, 768, dict(w_bits=4)),
    ("mamba2 chunk in_proj", 256, 3352, 768, dict(w_bits=4)),
    ("mamba2 decode out_proj", 4, 768, 1536, dict(w_bits=4)),
    # jamba-1.5-large-398b's mamba in_proj, w2: N 2 x 16384 + 2 x 8 x
    # 128 + 128 = 34944, K 8192, at decode and at a chunk
    ("jamba decode in_proj", 4, 34944, 8192, {}),
    ("jamba chunk in_proj", 256, 34944, 8192, {}),
    # seamless-m4t-medium's GELU up projection at its own w4: at decode
    # and at its encoder's 64 and 128 frames (the chunk route); its
    # lm_head (vocab 256206 padded to 256256)
    ("seamless decode up", 4, 4096, 1024, dict(act="gelu", w_bits=4)),
    ("seamless encoder up 64", 64, 4096, 1024,
     dict(act="gelu", w_bits=4)),
    ("seamless encoder up 128", 128, 4096, 1024,
     dict(act="gelu", w_bits=4)),
    ("seamless decode lm_head", 4, 256256, 1024, dict(w_bits=4)),
    # qwen2-vl-7b's down projection, w2: K = 18944, weight rows of 592
    # words, at decode and at a chunk's 256 rows; its lm_head
    ("qwen2-vl decode down", 4, 3584, 18944, dict(residual=True)),
    ("qwen2-vl chunk down", 256, 3584, 18944, dict(residual=True)),
    ("qwen2-vl decode lm_head", 4, 152064, 3584, {}),
)


def k1_phase(torch, timer, seed, results):
    from repro_torch.kernels import apmm
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cache: dict = {}
    cases = list(K1_CASES)
    # the bitserial variant's route edge: its stacked route's last M and
    # the rows route's first, at the decode gate/up shape
    edge = apmm.bitserial_stack_max()
    cases += [("stack edge gate/up", edge, 14336, 4096,
               dict(dual=True, act="silu")),
              ("rows edge gate/up", edge + 1, 14336, 4096,
               dict(dual=True, act="silu"))]
    for name, m, n, k, kw in cases:
        r, bs = _k1_case(torch, timer, g, name, m, n, k, cache=cache, **kw)
        results["apmm_fused_linear", name] = r
        results["apmm_fused_linear_bitserial", name] = bs
        if name in ("decode lm_head", "jamba chunk in_proj",
                    "seamless decode lm_head", "qwen2-vl decode lm_head"):
            cache.pop((n, k, False, kw.get("w_bits", 2)), None)
    cache.clear()
    torch.cuda.empty_cache()


# the nested checkpoint's K1 cases in phase 3: llama3-8b's dual gate/up
# packed once at w8 (the widest width, with its per-width scales), served
# at each of NESTED_BITS through ``bipolar.nested_slice`` -- plane-prefix
# views, not copies -- at decode (M = 4, the small-M route) and at a
# chunk (M = 1024, the int8 chunk route); each case is named
# "nested <step> gate/up k<bits>"
NESTED_BITS = (8, 4, 2)
NESTED_K1_M = {"decode": 4, "chunk": 1024}


@contextlib.contextmanager
def k1_calls():
    """Record each call of K1's C entry (either variant) while the block
    runs, as (the weight-plane pointers it is handed -- W's, and W2's
    where given --, the bytes of one plane, the planes it streams);
    yields the list."""
    from repro_torch.kernels import apmm
    lib, seen = apmm._lib, []

    def recording():
        fn = lib()

        def call(*args):
            # args 2 and 4: W's and W2's planes; 11, 13: N and Kw; 15: the
            # weight's bits
            seen.append((tuple(p for p in (args[2], args[4]) if p),
                         args[11] * args[13] * 4, args[15]))
            return fn(*args)
        return call

    apmm._lib = recording
    try:
        yield seen
    finally:
        apmm._lib = lib


def packed_stacks(tree, n_bits: int) -> set:
    """The pointers of the plane stacks of every ``n_bits``-plane
    ``BipolarTensor`` in ``tree`` (dicts, lists and tuples)."""
    from repro_torch.core.bipolar import BipolarTensor
    if isinstance(tree, BipolarTensor):
        return {tree.packed.data_ptr()} if tree.n_bits == n_bits else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(packed_stacks(v, n_bits) for v in tree))
    return set()


def k1_nested_phase(torch, timer, seed, results):
    """K1 and K1-bs on a nested w8 checkpoint's views (``NESTED_BITS``,
    ``NESTED_K1_M``): each view reaches the kernel uncopied (its planes
    are the full stack's last k, at the full stack's pointer plus
    ``8 - k`` planes), and ``_k1_case``'s checks hold on it (the integer
    core bit for bit against the plain version on the same view, the
    SiLU epilogue within 1 bf16 ulp, the bitserial kernel equal to the
    fused one), with its time, device split and the bound at k planes."""
    from repro_torch.core import bipolar
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    n, k, top = 14336, 4096, max(NESTED_BITS)
    full = [ops.pack_weight(torch.randn((n, k), generator=g, device="cuda"),
                            top) for _ in range(2)]
    plane = n * full[0].packed.shape[-1] * 4           # bytes a plane
    timed = set()
    for step, m in NESTED_K1_M.items():
        for bits in NESTED_BITS:
            w, w2 = (bipolar.nested_slice(f, bits) for f in full)
            want = tuple(f.packed.data_ptr() + (top - bits) * plane
                         for f in full)
            with k1_calls() as calls:
                r, bs = _k1_case(torch, timer, g,
                                 f"nested {step} gate/up k{bits}", m, n, k,
                                 dual=True, act="silu", weights=(w, w2),
                                 yardsticks=step not in timed)
            ptrs = {p for c in calls for p in c[0]}
            if ptrs != set(want) or {c[2] for c in calls} != {bits}:
                raise AssertionError(f"K1 nested {step} k{bits}: the kernel "
                                     f"streamed {sorted({c[2] for c in calls})}"
                                     f" planes at {ptrs}, not {bits} at the "
                                     f"views' {want}")
            print(f"K1 nested {step} gate/up k{bits}: every launch "
                  f"streamed the w{top} stacks' last {bits} planes in "
                  f"place (offset {top - bits} planes, no copy)",
                  flush=True)
            timed.add(step)
            case = f"nested {step} gate/up k{bits}"
            results["apmm_fused_linear", case] = r
            results["apmm_fused_linear_bitserial", case] = bs
    del full
    torch.cuda.empty_cache()


def _k2_inputs(torch, g, lanes, *, s_q, nb, window, h=8, group=4, d=128,
               n_bits=8, bs=16):
    """One K2 case: lane i holds ``lanes[i]`` tokens (positions 0..ctx-1)
    in blocks of its own, less the blocks wholly out of the window (the
    engine reclaims them: they are not in its table), its table padded
    to ``nb`` entries with the null block 0; None is a pad lane on an
    all-null table.  Queries: each lane's last ``s_q`` positions, the GQA
    group folded in (pad lanes -1); a lane that holds fewer than ``s_q``
    has all its positions, then pads (-1) up to ``s_q``: a bucketed whole
    prompt.  Returns the kernel's arguments."""
    from repro_torch.kernels import ops
    spans = []
    for ctx in lanes:
        if ctx is None:
            spans.append(None)
            continue
        lo = 0 if window is None else max(0, ctx - s_q + 1 - window)
        spans.append((ctx, lo // bs, -(-ctx // bs) - lo // bs))
    n_blocks = 1 + sum(sp[2] for sp in spans if sp)
    dw = -(-d // 32)                  # the head dim padded to whole words
    k_pool = torch.zeros((n_blocks, bs, h, n_bits, dw), dtype=torch.int32,
                         device="cuda")
    v_pool = torch.zeros_like(k_pool)
    k_sc = torch.zeros((n_blocks, bs, h, 1), device="cuda")
    v_sc = torch.zeros_like(k_sc)
    pos = torch.full((n_blocks, bs), -1, dtype=torch.int32, device="cuda")
    tables = torch.zeros((len(lanes), nb), dtype=torch.int32, device="cuda")
    q_pos = torch.full((len(lanes), group * s_q), -1, dtype=torch.int32,
                       device="cuda")
    nxt = 1
    for row, sp in enumerate(spans):
        if sp is None:
            continue
        ctx, first, n_blk = sp
        assert n_blk <= nb, (ctx, n_blk, nb)
        kv = torch.randn((2, n_blk * bs, h, d), generator=g,
                         device="cuda").to(torch.bfloat16)
        kq, ks = ops.quantize_kv(kv[0], n_bits)
        vq, vs = ops.quantize_kv(kv[1], n_bits)
        ids = torch.arange(nxt, nxt + n_blk, device="cuda")
        nxt += n_blk
        tables[row, :n_blk] = ids.to(torch.int32)
        k_pool[ids] = kq.reshape(n_blk, bs, h, n_bits, dw)
        v_pool[ids] = vq.reshape(n_blk, bs, h, n_bits, dw)
        k_sc[ids] = ks.reshape(n_blk, bs, h, 1)
        v_sc[ids] = vs.reshape(n_blk, bs, h, 1)
        p = torch.arange(first * bs, (first + n_blk) * bs, dtype=torch.int32,
                         device="cuda")
        pos[ids] = torch.where(p < ctx, p, -1).reshape(n_blk, bs)
        n_q = min(s_q, ctx)
        qp = torch.full((s_q,), -1, dtype=torch.int32, device="cuda")
        qp[:n_q] = torch.arange(ctx - n_q, ctx, dtype=torch.int32,
                                device="cuda")
        q_pos[row] = qp[None, :].expand(group, s_q).reshape(-1)
    q = torch.randn((len(lanes), h, group * s_q, d), generator=g,
                    device="cuda").to(torch.bfloat16)
    return q, k_pool, k_sc, v_pool, v_sc, pos, tables, q_pos


def _k2_bound(torch, args, window, d, n_bits):
    """Bytes: each slot that some query row of its lane may see, once
    (its K and V planes and scales for every head, and its position),
    plus q, out, the positions and the tables; operations: 4 d flops per
    visible (query, slot) pair and head, at the f32 rate."""
    from repro_torch.kernels import ref
    q, _, _, _, _, pos, tables, q_pos = args
    b, h, gq, _ = q.shape
    kpos = ref.gather_paged_kv(pos[:, :, None], tables)[..., 0]
    valid = ref.position_mask(q_pos[:, :, None], kpos[:, None, :], True,
                              window)
    slots = int(valid.any(1).sum())
    slot_bytes = h * (2 * n_bits * -(-d // 32) * 4 + 8) + 4
    io_bytes = 2 * q.numel() * q.element_size() + q_pos.numel() * 4 \
        + tables.numel() * 4
    return bound_ms(slots * slot_bytes + io_bytes,
                    4 * d * int(valid.sum()) * h, F32_FLOPS_PER_S)


def k2_phase(torch, timer, seed, results):
    """K2 at ``K2_CASES``: within 1 bf16 ulp or 1e-5 of its plain version
    -- the split plain version (``ref.paged_attention_split``) where its C
    entry splits the table -- with the split count its C entry plans and
    the kernels that ran (the combine exactly when it splits)."""
    from repro_torch.kernels import flash_attention, ref
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    for name, lanes, s_q, nb, window, (h, group, d) in K2_CASES:
        n_bits = 8
        args = _k2_inputs(torch, g, lanes, s_q=s_q, nb=nb, window=window,
                          h=h, group=group, d=d, n_bits=n_bits)
        b, _, gq, _ = args[0].shape
        n_split = flash_attention.paged_splits(b, h, gq, nb)

        def run():
            return flash_attention.flash_attention_paged_quantized(
                *args, d=d, window=window)

        def run_plain():
            return ref.paged_attention(*args, d=d, window=window)

        got = run()
        want = ref.paged_attention_split(*args, splits=n_split, d=d,
                                         window=window)
        ok, err, ulps = _within(got, want)
        if not ok:
            raise AssertionError(f"K2 {name}: beyond 1 bf16 ulp and 1e-5 of "
                                 f"the {n_split}-range plain version (max "
                                 f"|err| {err})")
        split = traced_split(torch, timer, run, ["attention_kernel"])
        ran = kernel_names(split)
        if ("combine_kernel" in ran) != (n_split > 1):
            raise AssertionError(f"K2 {name}: {n_split} ranges planned, but "
                                 f"the kernels that ran were {ran}")
        ms = timer(run, iters=20)
        plain = timer(run_plain, iters=3, warmup=1)
        b_ms, b_by = _k2_bound(torch, args, window, d, n_bits)
        print(f"K2 paged attention {name} B={b} lanes={list(lanes)} "
              f"Gq={gq} (group {group}; {int((args[-1] >= 0).sum())} live "
              f"query rows) H={h} NB={nb} window={window} d={d} "
              f"({-(-d // 32)} words) kv8 bs=16: "
              f"{n_split} range(s) of the table (device ms: "
              f"{split_line(split)}); max|err| {err:.3g} against the {n_split}-range plain "
              f"version, max {ulps} bf16 ulps where |err| > 1e-5 (tol 1 "
              f"ulp or 1e-5); {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
              f"{100 * b_ms / ms:.1f}% of bound; "
              f"{versus_prev('K2 ' + name, b_ms)}), plain {plain:.4f} ms",
              flush=True)
        results["paged_attention", name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=None)
        del args, got, want
    torch.cuda.empty_cache()


def routed_counts(torch, gen, *, e, g, tg, k=2, cap, skew=0.0):
    """Keep counts ``(E, G)`` int32 of a top-``k`` routing of ``g`` groups
    of ``tg`` tokens with random router logits (``skew`` tilts them
    toward the low experts, for uneven loads); no token picks the last
    expert, so its count is 0."""
    import torch.nn.functional as F
    logits = torch.randn((g, tg, e), generator=gen, device="cuda")
    logits += skew * torch.linspace(1, -1, e, device="cuda")
    logits[..., e - 1] = -1e9
    top_e = logits.topk(k, dim=-1).indices.reshape(g, tg * k)
    oh = F.one_hot(top_e, e).to(torch.int32)
    pos = torch.gather(torch.cumsum(oh, 1) - oh, 2, top_e[..., None])[..., 0]
    keep = (pos < cap)[..., None].to(torch.int32)
    return (oh * keep).sum(1).T.contiguous().to(torch.int32)


def _k4_case(torch, timer, g_, name, *, e, groups, seg, k, n, counts,
             dual, w_bits=2, a_bits=8):
    from repro_torch.core import bipolar
    from repro_torch.kernels import moe, ops, ref
    from repro_torch.models.config import QuantConfig
    from repro_torch.models.model import _quantize_experts
    q = QuantConfig(w_bits=w_bits)

    def weight():
        return _quantize_experts(torch.randn((e, n, k), generator=g_,
                                             device="cuda"), q)

    w = weight()
    w2 = weight() if dual else None
    c = groups * seg
    x = torch.randn((e, c, k), generator=g_, device="cuda").to(torch.bfloat16)
    rows = torch.arange(c, device="cuda")
    live_rows = (rows % seg)[None, :] < counts[:, rows // seg]   # (E, C)
    x = torch.where(live_rows[..., None], x, torch.zeros_like(x))
    a_s = bipolar.absmax_scale(x.float(), a_bits, axis=-1)
    bc = ops.moe_row_tile(seg)
    act = "silu" if dual else "none"
    # the integer core of each weight: act=none, f32 out -- bit-exact,
    # dead rows exactly 0, the live map equal to the analytic one
    for wt in (w, w2) if dual else (w,):
        core, live = moe.moe_expert_linear(x, a_s, counts, wt, a_bits=a_bits,
                                           out_dtype=torch.float32, bc=bc)
        torch.cuda.synchronize()
        core_ref, live_ref = moe.moe_expert_linear_plain(
            x, a_s, counts, wt, a_bits=a_bits, out_dtype=torch.float32, bc=bc)
        if not torch.equal(core, core_ref):
            raise AssertionError(f"K4 {name}: integer core differs from "
                                 f"plain")
        if not torch.equal(live, live_ref):
            raise AssertionError(f"K4 {name}: live map {live.tolist()} != "
                                 f"{live_ref.tolist()}")
        if (~live_rows).any() and core[~live_rows].abs().max() != 0:
            raise AssertionError(f"K4 {name}: dead rows not zero")
        del core, core_ref
    got = moe.moe_expert_linear(x, a_s, counts, w, a_bits=a_bits,
                                out_dtype=torch.bfloat16, bc=bc)[0]
    want = ref.ap_moe_expert_linear_ref(x, a_s, counts, w, a_bits=a_bits,
                                        out_dtype=torch.bfloat16)
    if not torch.equal(got, want):
        raise AssertionError(f"K4 {name}: bf16 act=none output differs")

    def run():
        return moe.moe_expert_linear(x, a_s, counts, w, w2=w2, a_bits=a_bits,
                                     act=act, out_dtype=torch.bfloat16,
                                     bc=bc)[0]

    def run_plain():
        return ref.ap_moe_expert_linear_ref(x, a_s, counts, w, w2=w2,
                                            a_bits=a_bits, act=act,
                                            out_dtype=torch.bfloat16)

    got, want = run(), run_plain()
    err = (got.float() - want.float()).abs().max().item()
    ulps = int(bf16_ulps(got, want).max())
    if ulps > (1 if dual else 0):
        raise AssertionError(f"K4 {name} act={act}: bf16 output {ulps} "
                             f"ulps from plain (max |err| {err})")
    if (~live_rows).any() and got[~live_rows].abs().max() != 0:
        raise AssertionError(f"K4 {name}: dead rows not zero")
    ms = timer(run, iters=10)
    plain = timer(run_plain, iters=2, warmup=1)
    nw = 2 if dual else 1
    n_live = int(live_rows.sum())
    live_experts = int((counts.sum(1) > 0).sum())
    kw = w.packed.shape[-1]
    groups_ab = len(ref.plane_groups(a_bits)) * len(ref.plane_groups(w_bits))
    n_bytes = n_live * k * 2 + e * c * 4 + counts.numel() * 4 \
        + live_experts * nw * (w_bits * n * kw * 4 + n * 4) + e * c * n * 2
    n_ops = nw * groups_ab * 2 * n_live * n * k
    b_ms, b_by = bound_ms(n_bytes, n_ops, INT8_OPS_PER_S)
    route = "decode" if seg <= moe.fused_route_max() else "chunk"
    ran, split = fused_k4_routes(torch, timer, run)
    if ran != {route}:
        raise AssertionError(f"K4 {name}: ran the {sorted(ran)} route(s); "
                             f"the threshold {moe.fused_route_max()} gives "
                             f"seg={seg} the {route} route")
    split = bitserial_split(torch, timer, run, split)
    bs = _k4_bitserial(torch, timer, name, x, a_s, counts, w, w2, a_bits,
                       act, bc, live_rows, got, want, ms, b_ms, b_by)
    # yardstick (not the same function; the port never calls it)
    wb = torch.randn((e, k, nw * n), generator=g_, device="cuda").to(
        torch.bfloat16)
    mm = timer(lambda: torch.bmm(x, wb), iters=10)
    del wb
    print(f"K4 moe_expert_linear {name} E={e} G={groups} seg={seg} N={n} "
          f"K={k} w{w_bits}a{a_bits}{' dual' if dual else ''} act={act}, "
          f"{route} route (the "
          f"kernels that ran), "
          f"{n_live} live rows of {e * c}, {live_experts} live experts: core "
          f"bit-exact, live map equal, dead rows 0, out max|err| {err:.3g}, "
          f"{ulps} bf16 ulps (tol {1 if dual else 0}); {ms:.4f} ms (bound "
          f"{b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.1f}% of bound; "
          f"{versus_prev('K4 ' + name, b_ms)}; {split}), plain {plain:.4f} "
          f"ms; yardstick (not the same function): torch.bmm bf16 "
          f"{mm:.4f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), bs


def _k4_bitserial(torch, timer, name, x, a_s, counts, w, w2, a_bits, act,
                  bc, live_rows, fused_out, plain_fused, fused_ms, b_ms,
                  b_by):
    """K4's bitserial kernel at one phase-3 case (see ``_k4_case``): the
    integer core of each weight bit-exact to the plain bitserial version
    and to the fused kernel, the live map equal, dead rows 0, the output
    equal to the fused kernel's and within its tolerance of plain."""
    from repro_torch.kernels import moe, ref
    before = moe.BITSERIAL_LAUNCHES
    for wt in (w, w2) if w2 is not None else (w,):
        core, live = moe.moe_expert_linear(x, a_s, counts, wt, a_bits=a_bits,
                                           variant="bitserial",
                                           out_dtype=torch.float32, bc=bc)
        torch.cuda.synchronize()
        core_ref, live_ref = moe.moe_expert_linear_plain(
            x, a_s, counts, wt, a_bits=a_bits, variant="bitserial",
            out_dtype=torch.float32, bc=bc)
        fused, live_f = moe.moe_expert_linear(x, a_s, counts, wt,
                                              a_bits=a_bits,
                                              out_dtype=torch.float32, bc=bc)
        if not (torch.equal(core, core_ref) and torch.equal(core, fused)):
            raise AssertionError(f"K4 bitserial {name}: integer core differs "
                                 f"from plain or from fused")
        if not (torch.equal(live, live_ref) and torch.equal(live, live_f)):
            raise AssertionError(f"K4 bitserial {name}: live map differs")
        if (~live_rows).any() and core[~live_rows].abs().max() != 0:
            raise AssertionError(f"K4 bitserial {name}: dead rows not zero")
        del core, core_ref, fused

    def run():
        return moe.moe_expert_linear(x, a_s, counts, w, w2=w2, a_bits=a_bits,
                                     act=act, variant="bitserial",
                                     out_dtype=torch.bfloat16, bc=bc)[0]

    def run_plain():
        return ref.ap_moe_expert_linear_ref(x, a_s, counts, w, w2=w2,
                                            a_bits=a_bits, act=act,
                                            variant="bitserial",
                                            out_dtype=torch.bfloat16)

    got, want = run(), run_plain()
    if not torch.equal(got, fused_out) or not torch.equal(want, plain_fused):
        raise AssertionError(f"K4 bitserial {name}: output differs from the "
                             f"fused kernel's or plain from plain")
    err = (got.float() - want.float()).abs().max().item()
    ulps = int(bf16_ulps(got, want).max())
    if ulps > (1 if w2 is not None else 0):
        raise AssertionError(f"K4 bitserial {name}: {ulps} ulps from plain")
    if moe.BITSERIAL_LAUNCHES - before != (3 if w2 is not None else 2):
        raise AssertionError(f"K4 bitserial {name}: launch counter")
    ms = timer(run, iters=10)
    plain = timer(run_plain, iters=2, warmup=1)
    seg = x.shape[1] // counts.shape[1]
    route = "stacked" if seg <= moe.bitserial_stack_max() else "rows"
    kernels = {r: f"moe_bitserial_{r}_kernel" for r in ("stacked", "rows")}
    split = traced_split(torch, timer, run, list(kernels.values()))
    ran = {r for r, k in kernels.items() if k in kernel_names(split)}
    if ran != {route}:
        raise AssertionError(f"K4 bitserial {name}: ran the {sorted(ran)} "
                             f"route(s); the threshold "
                             f"{moe.bitserial_stack_max()} gives seg={seg} "
                             f"the {route} route")
    print(f"K4 moe_expert_linear_bitserial {name}, {route} route (the "
          f"kernels that ran): cores "
          f"bit-exact to plain and fused, live map equal, dead rows 0, out "
          f"equal to the fused kernel's, max|err| {err:.3g}, {ulps} bf16 "
          f"ulps; {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, the fused "
          f"row's; {100 * b_ms / ms:.1f}% of bound; "
          f"{versus_prev('K4-bs ' + name, b_ms)}; "
          f"{bitserial_split(torch, timer, run, split)}), fused kernel "
          f"{fused_ms:.4f} ms in this run, plain {plain:.4f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, fused_ms=fused_ms)


def k4_phase(torch, timer, seed, results):
    """K4 at mixtral-8x7b's shapes (E = 8, top 2, capacity factor 1.25),
    counts from a top-2 routing with one empty expert; then at
    deepseek-moe-16b's (E = 64, top 6, expert_d_ff 1408, its own w3) and
    jamba-1.5-large-398b's (E = 16, top 2, 24576 x 8192, w2) at the
    segment heights their traced steps give (``K4_STEP_SEGS``)."""
    g_ = torch.Generator(device="cuda").manual_seed(seed + 3)
    d, f = 4096, 14336
    dec = routed_counts(torch, g_, e=8, g=1, tg=4, cap=2)       # 4 lanes
    chunk = routed_counts(torch, g_, e=8, g=1, tg=1024, cap=320, skew=1.0)
    g32 = routed_counts(torch, g_, e=8, g=32, tg=128, cap=40)   # 4096 tok
    odd = routed_counts(torch, g_, e=4, g=2, tg=6, cap=4)
    cases = [
        ("decode gate/up", dict(e=8, groups=1, seg=2, k=d, n=f, counts=dec,
                                dual=True)),
        ("decode down", dict(e=8, groups=1, seg=2, k=f, n=d, counts=dec,
                             dual=False)),
        ("chunk gate/up", dict(e=8, groups=1, seg=320, k=d, n=f,
                               counts=chunk, dual=True)),
        ("G=32 down", dict(e=8, groups=32, seg=40, k=f, n=d, counts=g32,
                           dual=False)),
        ("odd", dict(e=4, groups=2, seg=4, k=1000, n=1000, counts=odd,
                     dual=True)),
    ]
    # the shapes phase 5's traced mixtral steps give K4 (K4_STEP_SEGS,
    # checked there)
    for kind, (tokens, seg) in K4_STEP_SEGS["mixtral-8x7b"].items():
        cases.append((f"{kind} step gate/up", dict(
            e=8, groups=1, seg=seg, k=d, n=f, dual=True,
            counts=routed_counts(torch, g_, e=8, g=1, tg=tokens, cap=seg))))
    # the route edges: the fused variant's decode route's tallest segment
    # and its chunk route's first; the bitserial variant's stacked route's
    # tallest and its rows route's first; at the gate/up shape
    from repro_torch.kernels import moe
    edges = (("decode edge gate/up", moe.fused_route_max()),
             ("chunk edge gate/up", moe.fused_route_max() + 1),
             ("stack edge gate/up", moe.bitserial_stack_max()),
             ("rows edge gate/up", moe.bitserial_stack_max() + 1))
    for name, seg in edges:
        cases.append((name, dict(
            e=8, groups=1, seg=seg, k=d, n=f, dual=True,
            counts=routed_counts(torch, g_, e=8, g=1, tg=4 * seg,
                                 cap=seg))))
    # deepseek-moe-16b's experts at its traced steps' heights, both
    # linears: gate/up N 1408 x K 2048, down N 2048 x K 1408
    ds_d, ds_f = 2048, 1408
    for kind, (tokens, seg) in K4_STEP_SEGS["deepseek-moe-16b"].items():
        counts = routed_counts(torch, g_, e=64, g=1, tg=tokens, k=6, cap=seg)
        cases += [(f"deepseek {kind} step gate/up", dict(
                       e=64, groups=1, seg=seg, k=ds_d, n=ds_f, dual=True,
                       counts=counts, w_bits=3)),
                  (f"deepseek {kind} step down", dict(
                       e=64, groups=1, seg=seg, k=ds_f, n=ds_d, dual=False,
                       counts=counts, w_bits=3))]
    # jamba-1.5-large-398b's experts, w2: gate/up N 24576 x K 8192, down
    # N 8192 x K 24576
    jb_d, jb_f = 8192, 24576
    for kind, (tokens, seg) in K4_STEP_SEGS["jamba-1.5-large-398b"].items():
        counts = routed_counts(torch, g_, e=16, g=1, tg=tokens, cap=seg)
        cases += [(f"jamba {kind} step gate/up", dict(
                       e=16, groups=1, seg=seg, k=jb_d, n=jb_f, dual=True,
                       counts=counts)),
                  (f"jamba {kind} step down", dict(
                       e=16, groups=1, seg=seg, k=jb_f, n=jb_d, dual=False,
                       counts=counts))]
    for name, kw in cases:
        r, bs = _k4_case(torch, timer, g_, name, **kw)
        results["moe_expert_linear", name] = r
        results["moe_expert_linear_bitserial", name] = bs
        torch.cuda.empty_cache()


def _k5_operands(torch, g, m, n, k, *, a_bits=8, w_bits=2,
                 extra_b_words=0):
    """K5's operands at one shape: A = K3-packed bf16 activations ``x``,
    B = a packed weight (``extra_b_words`` all-one alignment words widen
    its Kw).  Returns (x, A, B)."""
    import dataclasses
    from repro_torch.kernels import ops
    w = ops.pack_weight(torch.randn((n, k), generator=g, device="cuda"),
                        w_bits)
    if extra_b_words:
        fill = torch.full((w_bits, n, extra_b_words), -1, dtype=torch.int32,
                          device="cuda")
        w = dataclasses.replace(w, packed=torch.cat([w.packed, fill], -1))
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    a = ops.quantize_rows(x, a_bits, pad_bit=0)
    a, w = ops._normalize_packed_kw(a, w)
    return x, a, w


def _k5_case(torch, timer, g, name, m, n, k, *, a_bits=8, w_bits=2,
             extra_b_words=0):
    """K5 at one shape (``_k5_operands``): bit-exact raw and dequantized,
    on the route its threshold gives (read off the kernels that ran)."""
    from repro_torch.kernels import apmm, ref
    x, a, w = _k5_operands(torch, g, m, n, k, a_bits=a_bits, w_bits=w_bits,
                           extra_b_words=extra_b_words)
    before = apmm.PACKED_SMALL_M_LAUNCHES
    raw = apmm.apmm_packed(a, w)
    torch.cuda.synchronize()
    if not torch.equal(raw, ref.apmm_packed(a, w)):
        raise AssertionError(f"K5 {name}: raw int32 product differs")
    del raw
    for od in (torch.float32, torch.bfloat16):
        got = apmm.apmm_packed(a, w, out_dtype=od)
        want = ref.apmm_dequant(a, w, out_dtype=od)
        if not torch.equal(got, want):
            raise AssertionError(f"K5 {name}: {od} dequant differs")
    err = (got.float() - want.float()).abs().max().item()
    del got, want

    def run():
        return apmm.apmm_packed(a, w, out_dtype=torch.bfloat16)

    def run_plain():
        return ref.apmm_dequant(a, w, out_dtype=torch.bfloat16)

    small = m <= apmm.packed_small_m_max()
    if apmm.PACKED_SMALL_M_LAUNCHES - before != 3 * small:
        raise AssertionError(f"K5 {name}: small-M launch counter")
    route, split = _fused_route(torch, timer, f"K5 {name}", run, m,
                                apmm.packed_small_m_max(),
                                "packed_to_xq_kernel")
    ms = timer(run, iters=10)
    plain = timer(run_plain, iters=2, warmup=1)
    kw = w.packed.shape[-1]
    groups = len(ref.plane_groups(a_bits)) * len(ref.plane_groups(w_bits))
    n_bytes = (a_bits * m + w_bits * n) * kw * 4 + (m + n) * 4 + m * n * 2
    b_ms, b_by = bound_ms(n_bytes, groups * 2 * m * n * k, INT8_OPS_PER_S)
    bs = _k5_bitserial(torch, timer, name, a, w, ms, b_ms, b_by)
    wb = torch.randn((n, k), generator=g, device="cuda").to(torch.bfloat16)
    mm = timer(lambda: torch.matmul(x, wb.T), iters=10)
    mi = max(m, 32)               # torch._int_mm takes M > 16 on the card
    ki, ni = -(-k // 8) * 8, -(-n // 8) * 8   # and N, K multiples of 8
    xi = torch.randint(-127, 128, (mi, ki), device="cuda", dtype=torch.int8)
    wi = torch.randint(-127, 128, (ni, ki), device="cuda", dtype=torch.int8)
    im = timer(lambda: torch._int_mm(xi, wi.t()), iters=10)
    del wb, xi, wi
    print(f"K5 apmm_packed {name} M={m} N={n} K={k} Kw={kw} a{a_bits}w"
          f"{w_bits}: raw int32 and f32/bf16 dequant bit-exact; {route} "
          f"route (device ms: {split_line(split)}; "
          f"{bitserial_split(torch, timer, run, split)}); "
          f"{ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
          f"{100 * b_ms / ms:.1f}% of bound; "
          f"{versus_prev('K5 ' + name, b_ms)}), plain {plain:.4f} ms; "
          f"yardsticks (not the same "
          f"function): torch.matmul bf16 {mm:.4f} ms, torch._int_mm int8 "
          f"M={mi} N={ni} K={ki} {im:.4f} ms, x {groups} group pairs "
          f"{im * groups:.4f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), bs


def _k5_bitserial(torch, timer, name, a, w, fused_ms, b_ms, b_by):
    """K5's bitserial kernel on one case's packed operands: raw int32 and
    f32/bf16 dequant bit-exact to the plain bitserial version and to the
    fused kernel; timed at bf16 out beside the fused kernel."""
    from repro_torch.kernels import apmm
    before = apmm.PACKED_BITSERIAL_LAUNCHES
    for od in (None, torch.float32, torch.bfloat16):
        got = apmm.apmm_packed(a, w, variant="bitserial", out_dtype=od)
        torch.cuda.synchronize()
        want = apmm.apmm_packed_plain(a, w, variant="bitserial",
                                      out_dtype=od)
        if not torch.equal(got, want):
            raise AssertionError(f"K5 bitserial {name} out {od}: differs "
                                 f"from plain")
        if not torch.equal(got, apmm.apmm_packed(a, w, out_dtype=od)):
            raise AssertionError(f"K5 bitserial {name} out {od}: differs "
                                 f"from the fused kernel")
    err = (got.float() - want.float()).abs().max().item()
    if apmm.PACKED_BITSERIAL_LAUNCHES - before != 3:
        raise AssertionError(f"K5 bitserial {name}: launch counter")

    def run():
        return apmm.apmm_packed(a, w, variant="bitserial",
                                out_dtype=torch.bfloat16)

    # the route, read off the kernels that ran: the stacked kernel up to
    # the library's threshold, the rows kernel above (no SU kernel: the
    # stacked route sums SU from A's staged words)
    m = a.shape[0]
    route = "stacked" if m <= apmm.packed_bitserial_stack_max() else "rows"
    kernels = {r: f"apmm_packed_bitserial_{r}_kernel"
               for r in ("stacked", "rows")}
    split = traced_split(torch, timer, run, list(kernels.values()))
    ran = [k for k in kernel_names(split) if k in kernels.values()]
    if ran != [kernels[route]]:
        raise AssertionError(f"K5 bitserial {name}: ran {ran}, but the "
                             f"threshold "
                             f"{apmm.packed_bitserial_stack_max()} gives "
                             f"M={m} the {route} route alone")
    ms = timer(run, iters=10)
    plain = timer(lambda: apmm.apmm_packed_plain(
        a, w, variant="bitserial", out_dtype=torch.bfloat16), iters=2,
        warmup=1)
    print(f"K5 apmm_packed_bitserial {name} M={m} a{a.n_bits}w{w.n_bits}: "
          f"raw int32 and f32/bf16 dequant bit-exact to plain and fused; "
          f"{route} route (device ms: {split_line(split)}); "
          f"{ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, the fused row's; "
          f"{100 * b_ms / ms:.1f}% of bound; "
          f"{versus_prev('K5-bs ' + name, b_ms)}), fused kernel "
          f"{fused_ms:.4f} ms in this run, plain {plain:.4f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, fused_ms=fused_ms)


def _unfused_vs_fused(torch, g, name, m, n, k):
    """``ap_linear`` (K3 + K5) against ``ap_linear_fused`` (K1) on the
    same bf16 inputs: bit-exact at act=none and with a residual; the
    SwiGLU composed from two unfused linears within 1 bf16 ulp of K1's
    dual SiLU epilogue."""
    from repro_torch.kernels import ops, ref
    w, w2 = (ops.pack_weight(torch.randn((n, k), generator=g,
                                         device="cuda"), 2) for _ in (0, 1))
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    res = torch.randn((m, n), generator=g, device="cuda").to(torch.bfloat16)
    if not torch.equal(ops.ap_linear(x, w, a_bits=8),
                       ops.ap_linear_fused(x, w, a_bits=8)):
        raise AssertionError(f"K3+K5 vs K1 {name}: act=none differs")
    if not torch.equal(ops.ap_linear(x, w, a_bits=8) + res,
                       ops.ap_linear_fused(x, w, a_bits=8, residual=res)):
        raise AssertionError(f"K3+K5 vs K1 {name}: residual differs")
    h = (ref.silu_f32(ops.ap_linear(x, w, a_bits=8).float())
         * ops.ap_linear(x, w2, a_bits=8).float()).to(torch.bfloat16)
    ulps = int(bf16_ulps(h, ops.ap_linear_fused(x, w, w2=w2, a_bits=8,
                                                act="silu")).max())
    if ulps > 1:
        raise AssertionError(f"K3+K5 vs K1 {name}: SwiGLU {ulps} ulps")
    print(f"ap_linear (K3+K5) vs ap_linear_fused (K1) {name} M={m} N={n} "
          f"K={k}: act=none and +residual bit-exact, SwiGLU {ulps} bf16 "
          f"ulps (tol 1)", flush=True)


_ODD = dict(extra_b_words=3)
# K5's cases in phase 3: (name, M, N, K, options of _k5_operands)
K5_CASES = (("decode q", 4, 4096, 4096, {}),
            ("decode gate", 4, 14336, 4096, {}),
            ("decode down", 4, 4096, 14336, {}),
            ("decode lm_head", 4, 128256, 4096, {}),
            ("chunk q", 1024, 4096, 4096, {}),
            ("chunk gate", 1024, 14336, 4096, {}),
            ("odd, unequal Kw", 5, 1000, 1000, _ODD),
            # the bitserial variant's width pairs at odd M/N/K
            ("odd a2w8", 5, 999, 1001, dict(a_bits=2, w_bits=8, **_ODD)),
            ("odd a8w8", 37, 999, 1001, dict(a_bits=8, w_bits=8, **_ODD)),
            ("odd a1w1", 5, 999, 1001, dict(a_bits=1, w_bits=1, **_ODD)),
            ("odd a3w5", 67, 999, 1001, dict(a_bits=3, w_bits=5, **_ODD)))


def k5_phase(torch, timer, seed, results):
    from repro_torch.kernels import apmm
    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    # the bitserial variant's route edge: its stacked route's last M and
    # the rows route's first, at the decode gate shape
    edge = apmm.packed_bitserial_stack_max()
    cases = list(K5_CASES) + [("stack edge gate", edge, 14336, 4096, {}),
                              ("rows edge gate", edge + 1, 14336, 4096, {})]
    for name, m, n, k, kw in cases:
        r, bs = _k5_case(torch, timer, g, name, m, n, k, **kw)
        results["apmm_packed", name] = r
        results["apmm_packed_bitserial", name] = bs
        torch.cuda.empty_cache()
    for name, m, n, k in (("decode gate", 4, 14336, 4096),
                          ("decode down", 4, 4096, 14336),
                          ("chunk q", 1024, 4096, 4096),
                          ("odd", 5, 1000, 1000)):
        _unfused_vs_fused(torch, g, name, m, n, k)
    torch.cuda.empty_cache()


def _within(got, want):
    """Elements within 1 bf16 ulp or 1e-5 absolute; returns (ok, max
    |err|, max ulps among elements more than 1e-5 apart -- near zero a
    sign flip spans many ulps and the 1e-5 rule holds)."""
    diff = (got.float() - want.float()).abs()
    ulps = bf16_ulps(got, want)
    far = diff > 1e-5
    ok = not bool((far & (ulps > 1)).any())
    return ok, diff.max().item(), int(ulps[far].max()) if far.any() else 0


def _ring_case(torch, g, *, b, t, live, s, h=8, group=4, d=128, n_bits=8,
               prefill=False, cross=False):
    """One contiguous ring per batch row, ``live`` slots valid (positions
    0..live-1; a sequence gives each row its own count, the rest of the
    row at -1); ``s`` query tokens per row, the GQA group folded in.
    Decode: the last ``s`` positions; prefill: positions 0..live-1 then
    pads (-1) up to ``s`` -- the bucketed prompt; cross: every query at
    position 0 (an enc-dec cross read, not causal)."""
    from repro_torch.kernels import ops
    kv = torch.randn((2, b, t, h, d), generator=g,
                     device="cuda").to(torch.bfloat16)
    # the ring as the contiguous engine holds it: dense (B, T, H, ...)
    kq, ks, vq, vs = (x.contiguous() for x in (*ops.quantize_kv(
        kv[0], n_bits), *ops.quantize_kv(kv[1], n_bits)))
    pos = torch.full((b, t), -1, dtype=torch.int32, device="cuda")
    for row, n in enumerate([live] * b if isinstance(live, int) else live):
        pos[row, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
    if cross:
        tok = torch.zeros((s,), dtype=torch.int32, device="cuda")
    elif prefill:
        tok = torch.full((s,), -1, dtype=torch.int32, device="cuda")
        tok[:live] = torch.arange(live, dtype=torch.int32, device="cuda")
    else:
        tok = torch.arange(live - s, live, dtype=torch.int32, device="cuda")
    q_pos = tok[None, None, :].expand(b, group, s).reshape(
        b, group * s).contiguous()
    q = torch.randn((b, h, group * s, d), generator=g,
                    device="cuda").to(torch.bfloat16)
    return q, kv, (kq, ks, vq, vs), pos, q_pos


def _attn_bound(torch, q_pos, kv_pos, h, d, kv_slot_bytes, io_bytes,
                rate, window=None, causal=True):
    """Bytes: each live KV slot once (``kv_slot_bytes`` per (row, slot,
    head)) plus q, out and positions; operations: 4 d flops per visible
    (query, slot) pair at ``rate`` (K6: f32; K7: the bf16 tensor-core
    rate) -- what this run's data needs."""
    from repro_torch.kernels import ref
    live = int((kv_pos >= 0).sum()) * h
    pairs = int(ref.position_mask(q_pos[:, :, None], kv_pos[:, None, :],
                                  causal, window).sum()) * h
    return bound_ms(live * kv_slot_bytes + io_bytes, 4 * d * pairs, rate)


def _k6_check(torch, timer, results, name, args, *, h, d, n_bits,
              causal=True, window=None):
    """K6 at one case: within 1 bf16 ulp or 1e-5 of its plain version and
    of the plain version of its split plan, with the split count and the
    kernels that ran (the combine exactly when it splits); times it and
    its plain version against its bound and records them under
    ``name``.  Returns its output."""
    from repro_torch.kernels import flash_attention, ref
    q, q_pos, pos = args[0], args[5], args[6]
    b, sq, t = q.shape[0], q.shape[2], pos.shape[1]
    kw = dict(d=d, causal=causal, window=window)

    def run():
        return flash_attention.flash_attention_quantized(*args, **kw)

    def run_plain():
        return ref.kv_cache_attention(*args, **kw)

    n_split = flash_attention.quantized_splits(b, h, sq, t)
    got, want = run(), run_plain()
    ok, err, ulps = _within(got, want)
    if not ok:
        raise AssertionError(f"K6 {name}: beyond 1 bf16 ulp and 1e-5 "
                             f"(max |err| {err})")
    ok, err_s, ulps_s = _within(got, ref.kv_cache_attention_split(
        *args, splits=n_split, **kw))
    if not ok:
        raise AssertionError(f"K6 {name}: beyond 1 bf16 ulp and 1e-5 of "
                             f"the {n_split}-range plain version (max "
                             f"|err| {err_s})")
    split = traced_split(torch, timer, run, ["attention_kernel"])
    ran = kernel_names(split)
    if ("combine_kernel" in ran) != (n_split > 1):
        raise AssertionError(f"K6 {name}: {n_split} ranges planned, but "
                             f"the kernels that ran were {ran}")
    ms = timer(run, iters=20)
    plain = timer(run_plain, iters=3, warmup=1)
    io = 2 * q.numel() * 2 + q_pos.numel() * 4 + pos.numel() * 4
    b_ms, b_by = _attn_bound(torch, q_pos, pos, h, d,
                             2 * (n_bits * d // 8 + 4), io,
                             F32_FLOPS_PER_S, window, causal)
    dev = sum(split.values())
    lives = (pos >= 0).sum(1).tolist()
    live = lives[0] if len(set(lives)) == 1 else lives
    print(f"K6 flash_attention_quantized {name}"
          f"{'' if causal else ' (not causal)'} B={b} H={h} Sq={sq} T={t} "
          f"live={live} d={d} kv{n_bits}: {n_split} range(s) of the rows' "
          f"tiles (device ms: {split_line(split)}); max|err| {err:.3g}, max "
          f"{ulps} bf16 ulps beyond 1e-5 (tol 1), against the "
          f"{n_split}-range plain version {err_s:.3g}, {ulps_s} ulps; "
          f"{ms:.4f} ms, device {dev:.4f} ms (bound {b_ms:.4f} ms by "
          f"{b_by}, {100 * b_ms / ms:.1f}% of bound, device "
          f"{100 * b_ms / dev:.1f}%; {versus_prev('K6 ' + name, b_ms)}), "
          f"plain {plain:.4f} ms", flush=True)
    results["flash_attention_quantized", name] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    return got


def _k7_within(torch, got, want):
    """K7's bar: bf16 within 1 bf16 ulp or 1e-5 (``_within``); f32 within
    1e-5 absolute or 1e-6 relative (the card tests' f32 rule).  Returns
    (ok, max |err|, the bar's words)."""
    if got.dtype == torch.bfloat16:
        ok, err, ulps = _within(got, want)
        return ok, err, f"max {ulps} bf16 ulps beyond 1e-5 (tol 1)"
    diff = (got - want).abs()
    ok = bool(((diff <= 1e-5) | (diff <= 1e-6 * want.abs())).all())
    return ok, diff.max().item(), "tol 1e-5 absolute or 1e-6 relative"


def _k7_case(torch, timer, results, name, qf, kf, vf, qpf, kpf, window):
    """K7 at one K6 case's folded K/V in qf's dtype: bf16 takes the
    tensor-core route (``flash_attention_mma_kernel``), f32 the
    register-tiled FFMA route (``float_flash_kernel``), each split over T
    where its C entry plans it, the combine seen to run exactly when it
    splits (read off the kernels that ran).  Within its bar (``_k7_within``)
    of the plain version and of the plain version of its split at the
    kernel's own ranges, fully masked rows exactly 0; its time and
    device time against its bound (bf16: the tensor-core rate; f32: 67
    TFLOP/s) and against one SDPA call in the same dtype.  Records it
    under ``flash_attention`` (bf16) or ``flash_attention_f32``; returns
    its launches."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref
    bf16 = qf.dtype == torch.bfloat16
    bh, sq, d = qf.shape
    key, tag = ("flash_attention", "") if bf16 else \
        ("flash_attention_f32", " f32")
    kernel = "flash_attention_mma_kernel" if bf16 else "float_flash_kernel"
    before = flash_attention.FLOAT_LAUNCHES

    def run7():
        return flash_attention.flash_attention(qf, kf, vf, qpf, kpf,
                                               window=window)

    def run7_plain():
        return ref.flash_attention(qf, kf, vf, qpf, kpf, window=window)

    got, want = run7(), run7_plain()
    ok, err, tol = _k7_within(torch, got, want)
    if not ok:
        raise AssertionError(f"K7{tag} {name}: beyond its tolerance (max "
                             f"|err| {err})")
    pads = qpf < 0                        # the prefill's padded rows
    if pads.any() and got[pads].abs().max() != 0:
        raise AssertionError(f"K7{tag} {name}: a fully masked row is not 0")
    if flash_attention.FLOAT_LAUNCHES - before != 1:
        raise AssertionError(f"K7{tag} {name}: launch counter")
    n_split = flash_attention.float_splits(bh, sq, kf.shape[1], qf.dtype)
    ok, err_s, _ = _k7_within(torch, got, ref.flash_attention_split(
        qf, kf, vf, qpf, kpf, splits=n_split, tile=ref.FLOAT_TILE,
        window=window))
    if not ok:
        raise AssertionError(f"K7{tag} {name}: beyond its tolerance of the "
                             f"{n_split}-range plain version (max |err| "
                             f"{err_s})")
    split = traced_split(torch, timer, run7, [kernel])
    ran = [k for k in kernel_names(split) if k in (
        "float_flash_kernel", "flash_attention_mma_kernel",
        "combine_kernel")]
    if ran != sorted([kernel] + ["combine_kernel"] * (n_split > 1)):
        raise AssertionError(f"K7{tag} {name}: {n_split} T range(s) "
                             f"planned, but the kernels that ran were {ran}")
    ms = timer(run7, iters=20)
    plain = timer(run7_plain, iters=3, warmup=1)
    size = qf.element_size()
    io = 2 * qf.numel() * size + qpf.numel() * 4 + kpf.numel() * 4
    b_ms, b_by = _attn_bound(torch, qpf, kpf, 1, d, 2 * size * d, io,
                             BF16_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S,
                             window)
    # the library yardstick: one SDPA call with the boolean position mask
    # computes K7's function on query rows that see some slot (SDPA turns
    # a fully masked row into NaN; K7 into 0)
    seen = ref.position_mask(qpf[:, :, None], kpf[:, None, :], True,
                             window).any(-1).all(0)
    qs, qps = qf[:, seen], qpf[:, seen]
    mask = ref.position_mask(qps[:, :, None], kpf[:, None, :], True, window)
    lib = timer(lambda: F.scaled_dot_product_attention(
        qs, kf, vf, attn_mask=mask), iters=20)
    lib_err = (F.scaled_dot_product_attention(qs, kf, vf, attn_mask=mask)
               .float() - want[:, seen].float()).abs().max().item()
    dev = sum(split.values())
    route = "mma" if bf16 else "FFMA"
    print(f"K7 flash_attention {name} BH={bh} Sq={sq} T={kf.shape[1]} "
          f"d={d} {'bf16' if bf16 else 'f32'}, {route} route, {n_split} T "
          f"range(s) (device ms: {split_line(split)}): max|err| "
          f"{err:.3g}, {tol}, against the {n_split}-range plain version "
          f"{err_s:.3g}; {int(pads.sum())} padded query row(s), exactly 0; "
          f"{ms:.4f} ms, device {dev:.4f} ms (bound "
          f"{b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.1f}% of bound, "
          f"device {100 * b_ms / dev:.1f}%; "
          f"{versus_prev('K7' + tag + ' ' + name, b_ms)}), plain "
          f"{plain:.4f} ms; "
          f"library: scaled_dot_product_attention with a boolean mask "
          f"over the {qs.shape[1]} of {sq} query rows that see a slot "
          f"{lib:.4f} ms (max|err| vs plain {lib_err:.3g})", flush=True)
    results[key, name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                              bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    launches = flash_attention.FLOAT_LAUNCHES - before
    del got, want
    return launches


def k6_k7_phase(torch, timer, seed, results):
    """K6 over a contiguous packed ring and K7 over the same K/V in
    bf16, at llama3-8b's shapes (8 kv heads, GQA group 4, d 128): decode
    (4 rows, ring 1024 with 632 live slots), the bucketed prefill of the
    600-token prompt (4 x 1024 query rows, T 1024), a 256-slot window,
    and a fully masked query row; K6 against K2 on the same K/V; K7's
    bf16 (tensor-core) and f32 (FFMA) routes at each case (``_k7_case``).
    Returns K7's launches by route."""
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    h, d, n_bits = 8, 128, 8
    launches = {torch.bfloat16: 0, torch.float32: 0}
    for name, kw, window in K6_CASES:
        q, kv, planes, pos, q_pos7 = _ring_case(torch, g, h=h, d=d,
                                                n_bits=n_bits, **kw)
        q_pos = q_pos7
        if name == "decode":
            q_pos = q_pos7.clone()
            q_pos[3, 0] = -1                  # a fully masked query row
        b, sq = q.shape[0], q.shape[2]
        got = _k6_check(torch, timer, results, name,
                        (q, *planes, q_pos, pos), h=h, d=d, n_bits=n_bits,
                        window=window)
        if name == "decode":
            if got[3, :, 0].abs().max() != 0:
                raise AssertionError("K6: a fully masked row is not 0")
            _k6_vs_k2(torch, q, planes, pos, q_pos, d)
        # K7 on the same K/V in bf16, then in f32, folded (B*H, T, d); its
        # decode queries have no fully masked row (the prefill's pads do)
        qf = q.reshape(b * h, sq, d)
        kf, vf = (ref.fold_kv_heads(x) for x in (kv[0], kv[1]))
        qpf = q_pos7.repeat_interleave(h, 0)
        kpf = pos.repeat_interleave(h, 0)
        for dt in (torch.bfloat16, torch.float32):
            launches[dt] += _k7_case(torch, timer, results, name,
                                     *(x.to(dt) for x in (qf, kf, vf)), qpf,
                                     kpf, window)
        del q, kv, planes, got
        torch.cuda.empty_cache()
    return {"flash_attention": launches[torch.bfloat16],
            "flash_attention_f32": launches[torch.float32]}


def k6_cross_phase(torch, timer, seed, results):
    """K6 not causal at ``K6_CROSS_CASES`` (seamless-m4t-medium's
    cross-attention reads: 16 heads, d 64, kv8, queries at position 0,
    each lane's rows past its live ones at position -1), through
    ``_k6_check``."""
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    h, d, n_bits = 16, 64, 8
    for name, lives, sq, t in K6_CROSS_CASES:
        # the slot rows as the paged engine gathers them: dense (B, T, H,
        # ...), as the model hands them to the kernel
        q, kv, planes, pos, q_pos = _ring_case(
            torch, g, b=len(lives), t=t, live=lives, s=sq, h=h, group=1,
            d=d, n_bits=n_bits, cross=True)
        _k6_check(torch, timer, results, name, (q, *planes, q_pos, pos),
                  h=h, d=d, n_bits=n_bits, causal=False)
        del q, kv, planes
    torch.cuda.empty_cache()


def _k6_vs_k2(torch, q, planes, pos, q_pos, d, bs=16):
    """The same K/V written into pool blocks: K2 through the block
    tables against K6 over the ring."""
    from repro_torch.kernels import flash_attention
    kq, ks, vq, vs = planes
    b, t = pos.shape
    nb = t // bs

    def blocks(x):
        pool = torch.zeros((1 + b * nb, bs) + tuple(x.shape[2:]),
                           dtype=x.dtype, device="cuda")
        pool[1:] = x.reshape((b * nb, bs) + tuple(x.shape[2:]))
        return pool

    pool_pos = blocks(pos)
    pool_pos[0] = -1
    tables = (1 + torch.arange(b * nb, dtype=torch.int32,
                               device="cuda")).reshape(b, nb)
    k2 = flash_attention.flash_attention_paged_quantized(
        q, blocks(kq), blocks(ks), blocks(vq), blocks(vs), pool_pos, tables,
        q_pos, d=d)
    k6 = flash_attention.flash_attention_quantized(q, kq, ks, vq, vs, q_pos,
                                                   pos, d=d)
    ok, err, ulps = _within(k6, k2)
    if not ok:
        raise AssertionError(f"K6 vs K2: beyond 1 bf16 ulp and 1e-5 "
                             f"(max |err| {err})")
    print(f"K6 vs K2 on the same K/V (ring vs 16-slot pool blocks): max|err| "
          f"{err:.3g}, max {ulps} bf16 ulps beyond 1e-5 (tol 1)", flush=True)


# ---------------------------------------------------------------------------
# phase 4: full width, shallow, card vs CPU
# ---------------------------------------------------------------------------

def _to_cpu(tree):
    from repro_torch.core.bipolar import BipolarTensor
    if isinstance(tree, BipolarTensor):
        return tree.to("cpu")
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def norm_phase(torch, timer, seed):
    """``layers.norm_apply`` on the card: its output stays on the card
    and equals the CPU's bits (the same torch ops: serial f32 sums, the
    rsqrt estimate and Newton steps, f64 products for the FMAs), at
    llama3-8b's width (rmsnorm, and layernorm) and at stablelm-3b's own
    layernorm with its bias (d 2560), decode and chunk rows; the decode
    call's time is its launches' (about 90 small ops)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    llama = get_config("llama3-8b")
    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    for cfg in (llama, dataclasses.replace(llama, norm_type="layernorm"),
                get_config("stablelm-3b")):
        norm = cfg.norm_type
        p = {"scale": torch.rand((cfg.d_model,), generator=g,
                                 device="cuda") + 0.5,
             "bias": torch.rand((cfg.d_model,), generator=g,
                                device="cuda") - 0.5}
        for rows in (4, 256):
            x = (3 * torch.randn((rows, cfg.d_model), generator=g,
                                 device="cuda")).to(torch.bfloat16)
            y = L.norm_apply(p, x, cfg)
            if y.device.type != "cuda":
                raise AssertionError("norm_apply left the card")
            cpu = L.norm_apply({k: v.cpu() for k, v in p.items()}, x.cpu(),
                               cfg)
            if not torch.equal(y.cpu(), cpu):
                raise AssertionError(f"norm_apply {norm} rows={rows}: card "
                                     f"bits differ from the CPU's")
        ms = timer(lambda: L.norm_apply(p, x[:4], cfg), iters=20)
        print(f"norm_apply {cfg.name} {norm} d={cfg.d_model} bf16 on the "
              f"card: bits "
              f"equal the CPU's at 4 and 256 rows; 4 rows {ms:.4f} ms",
              flush=True)


def shallow_phase(torch, seed, arch, n_layers, s, contiguous=False,
                  w_bits=None, nested=(None,), **over):
    """One full-width forward of ``s`` tokens at depth ``n_layers`` (and
    the config fields ``over``) on the card, then on the CPU, through the
    paged pool with the fused linear or (``contiguous``) a contiguous
    cache with the unfused linear; MoE layers record each token's top-k
    experts on both devices.  ``w_bits`` packs the weights at that width
    (a8) instead of the config's own; each entry of ``nested`` other
    than None serves them at that many bits (``QuantConfig.nested_bits``:
    the top planes of the one checkpoint), one forward a width on each
    device, each width held to the same bar.  A stateful stack's mamba
    layers, and an enc-dec model's cross caches, run on slot 1 of the
    pool's state slots; the enc-dec encoder takes random frames
    (``enc_len(cfg, s)`` of them), the VLM random patch embeddings and
    ``(3, 1, s)`` positions whose axes differ (height: two tokens a row;
    width: twice the index)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import enc_len
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    from repro_torch.serving.paged_cache import (PagedKVPool,
                                                 needs_state_slots)
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, **over)
    stateful = needs_state_slots(cfg)
    # the config's own weight and activation bits, a kv8 cache (none of
    # glm4, minicpm and deepseek sets kv_bits; the paged pool is packed)
    quant = dataclasses.replace(cfg.quant, kv_bits=8,
                                fused_linear=not contiguous)
    if w_bits is not None:
        quant = dataclasses.replace(quant, w_bits=w_bits, a_bits=8)
    path = ("contiguous cache, unfused linear" if contiguous else
            "paged pool, fused linear") + \
        f", w{quant.w_bits}/a{quant.a_bits}/kv8"
    params = M.init_params(cfg, seed=seed, device="cuda", quant=quant)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (1, s), dtype=np.int32)
    batch_np = dict(tokens=toks, positions=np.arange(s, dtype=np.int32)[None],
                    last_idx=np.array([s - 1], np.int32))
    inputs, n_frames = {}, None        # the stub frontends' inputs
    if cfg.family == "vlm":
        p = np.arange(s, dtype=np.int32)
        batch_np["positions"] = np.stack([p, p // 2, 2 * p])[:, None]
        inputs["patch_embeds"] = rng.standard_normal(
            (1, min(cfg.n_patches, s), cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        n_frames = enc_len(cfg, s)
        inputs["frames"] = rng.standard_normal(
            (1, n_frames, cfg.frontend_dim)).astype(np.float32)
    nb = -(-s // 16)
    tables = np.arange(1, nb + 1, dtype=np.int32)[None]
    lens = np.zeros(1, np.int32)
    routes: dict = {}
    margins: dict = {}
    moe_apply = L.moe_apply

    def recording_moe_apply(p, x, cfg_, quant=None, **kw):
        lg = torch.einsum("btd,ed->bte", x.float(), p["router"]["w"])
        probs = torch.softmax(lg, -1)
        top = torch.topk(probs, cfg_.top_k, -1).indices
        routes.setdefault(x.device.type, []).append(
            top.sort(-1).values.cpu())
        # the router's margin: the k-th probability over the next one
        srt = probs.sort(-1, descending=True).values
        margins.setdefault(x.device.type, []).append(
            (srt[..., cfg_.top_k - 1] - srt[..., cfg_.top_k]).cpu())
        return moe_apply(p, x, cfg_, quant, **kw)

    out = {}
    L.moe_apply = recording_moe_apply
    try:
        for dev, p in (("cuda", params), ("cpu", None)):
            if p is None:
                p = _to_cpu(params)
                del params
                torch.cuda.empty_cache()
            for bits in nested:
                q = quant if bits is None else dataclasses.replace(
                    quant, nested_bits=bits)
                if contiguous:
                    caches = M.init_caches(cfg, 1, nb * 16, quant=q,
                                           device=dev)
                else:
                    caches = PagedKVPool(
                        cfg, nb + 1, 16, quant=q, device=dev,
                        n_state_slots=1 if stateful else 0,
                        enc_len=n_frames).step_caches(
                            tables, lens, slots=np.ones(1, np.int32)
                            if stateful else None)
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in batch_np.items()}
                batch.update({k: torch.as_tensor(v, device=dev).to(
                    torch.bfloat16) for k, v in inputs.items()})
                t0 = time.time()
                logits, _ = E.prefill_step_bucketed(p, batch, caches, cfg,
                                                    q)
                out[dev, bits] = logits.float().cpu()
                served = "" if bits is None else f" served at {bits} bits"
                print(f"{arch} full width depth {n_layers} ({path}"
                      f"{served}): forward on {dev} in "
                      f"{time.time() - t0:.2f} s", flush=True)
                del caches
            del p
    finally:
        L.moe_apply = moe_apply
    for bits in nested:
        label = path if bits is None else f"{path} served at {bits} bits"
        _shallow_check(torch, arch, cfg, n_layers, s, label,
                       out["cuda", bits], out["cpu", bits], routes, margins,
                       stateful, n_frames)
    torch.cuda.empty_cache()


def _shallow_check(torch, arch, cfg, n_layers, s, path, a, b, routes,
                   margins, stateful, n_frames):
    """Hold one of ``shallow_phase``'s card logits ``a`` to the CPU's
    ``b`` (5% of the largest CPU logit) and print the comparison."""
    if not (torch.isfinite(a).all() and a.shape == (1, cfg.vocab_padded)):
        raise AssertionError("card logits not finite / wrong shape")
    # the vocab's pad columns (minicpm: 122753 of 122880) are masked to
    # -1e30 on both devices; the tolerance is taken over the real ones
    if not torch.equal(a[:, cfg.vocab:], b[:, cfg.vocab:]):
        raise AssertionError(f"{arch}: the vocab's pad logits differ")
    a, b = a[:, :cfg.vocab], b[:, :cfg.vocab]
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    routed = ""
    if routes:
        rc, rg = torch.cat(routes["cpu"]), torch.cat(routes["cuda"])
        same = (rc == rg).all(-1).float().mean().item()
        routed = (f"; {100 * same:.1f}% of {rc.shape[0] * rc.shape[1]} "
                  f"token-layer routings pick the same top-{cfg.top_k} "
                  f"experts on the card and the CPU")
        # each token's agreement (experts in both top-k sets), layer by
        # layer, and the smallest router margin, before the bar: a miss
        # then shows whether a route flipped
        agree = [[len(set(a.tolist()) & set(b.tolist()))
                  for a, b in zip(lc[0], lg_[0])]
                 for lc, lg_ in zip(routes["cpu"], routes["cuda"])]
        margin = min(float(m.min()) for m in margins["cpu"])
        print(f"{arch} top-{cfg.top_k} agreement card vs CPU, each token "
              f"by MoE layer: {agree}; smallest router margin (CPU, k-th "
              f"over the next probability) {margin:.3g}", flush=True)
    if err > 0.05 * scale:
        raise AssertionError(f"{arch} card vs CPU logits: max|err| {err} > "
                             f"5% of {scale}{routed}")
    plan = "".join("A" if cfg.layer_kind(i) == "attn" else "M"
                   for i in range(n_layers)) if stateful else ""
    plan = "; layers " + plan if plan else ""
    if cfg.family == "audio":
        plan = (f"; {cfg.enc_layers} encoder layers on {n_frames} random "
                f"frames, the cross caches on slot 1")
    if cfg.family == "vlm":
        plan = "; random patch embeddings, M-RoPE axes (t, t // 2, 2 t)"
    print(f"{arch} full width depth {n_layers} ({path}{plan}; d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, {s} tokens): card vs CPU "
          f"logits max|err| {err:.4g} "
          f"(tol 5% of max|logit| {scale:.4g}), argmax card "
          f"{int(a.argmax())} cpu {int(b.argmax())}{routed}", flush=True)


# ---------------------------------------------------------------------------
# phase 5: end to end
# ---------------------------------------------------------------------------

def fresh_memory(torch) -> float:
    """Free what an earlier phase left (its engine and parameters sit in
    reference cycles until the collector runs), reset the peak counter,
    and return the GiB still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2**30


def profile_steps(torch, step, n_steps: int, kind: str = "decode"):
    """``torch.profiler`` over ``n_steps`` calls of ``step`` (an engine's
    or a trainer's) of ``kind``, recording the device's activity only (no
    caller reads a host op, and recording them adds the profiler's own
    host cost to the window): device time by kernel name and the
    device's busy share of the window.  Returns the trace, or None where
    the profiler recorded no device time (it has dropped a whole window's
    activity; the caller traces again, and fails if no trace comes
    back)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAUSE_S)
        t0 = time.time()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
        time.sleep(PROFILER_PAUSE_S)
    rows = []
    busy, n_dev = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev = device_us(ev)
        if dev > 0:
            rows.append((dev, ev.count, ev.key))
            busy += dev
            n_dev += ev.count
    if not rows:
        PROFILER_DROPS["profile_steps"] += 1
        print(f"profile of {n_steps} {kind} steps: wall "
              f"{wall_us / 1e3:.1f} ms, the profiler recorded no device "
              f"time", flush=True)
        return None
    rows.sort(reverse=True)
    print(f"profile of {n_steps} {kind} steps: wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%, "
          f"idle {100 - 100 * busy / wall_us:.1f}%), {n_dev} device "
          f"kernels and copies", flush=True)
    for dev, cnt, key in rows[:12]:
        print(f"  {dev / 1e3:9.3f} ms  {cnt:6d} x  {key[:90]}", flush=True)
    return prof


def traced_kernels(torch, prof, pattern: str) -> dict:
    """Device ms and launches of each kernel of a ``profile_steps`` trace
    whose name matches ``pattern`` (a regular expression), by its own
    name."""
    from torch.autograd import DeviceType
    out: dict = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or not re.search(pattern,
                                                              ev.key):
            continue
        ms, n = out.get(kernel_name(ev.key), (0.0, 0))
        out[kernel_name(ev.key)] = (ms + device_us(ev) / 1e3, n + ev.count)
    return out


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "minicpm-2b"      # the reference's WSD model
TRAIN_STEPS = 8
# card vs CPU, one step at 2 layers: the loss within 1e-6 of its value,
# the gradient norm within 5e-5, each leaf's gradient within 2e-2 in
# relative L2 norm (a few times the gaps measured on the H100: 2.4e-7,
# 1.4e-5 and 9.0e-3, where cuBLAS's bf16 products round in another order
# than the CPU's).  A control whose loss takes its logsumexp in bf16 must
# miss one of them.  (The logits themselves are the bf16 product in both
# packages, cast to f32 before the logsumexp.)  A second control runs
# the attention core in bf16; its gaps are printed, not held: at random
# initialisation they sit within 1.5x of the sound card's.
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL, TRAIN_GRAD_TOL = 1e-6, 5e-5, 2e-2


def train_phase(torch, seed) -> None:
    """``TRAIN_ARCH`` at full width and depth trains ``TRAIN_STEPS``
    steps on ``DataSpec(vocab, seq_len=512, global_batch=4)`` through
    ``Trainer.train_step`` (WSD: warmup 2, peak lr 1e-3; f32 moments;
    step 0 runs at lr 0): each step's loss, lr, gradient norm and time,
    the median step time (the first step, with its warm-up, left out),
    ``max_memory_allocated``, then one profiled step (device busy and
    idle share, the largest device rows).  Every loss must be finite and
    the last below the first, and no kernel of K1-K7 may launch (the
    reference trains on the float path)."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataSpec
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = get_config(TRAIN_ARCH)
    spec = DataSpec(vocab=cfg.vocab, seq_len=512, global_batch=4, seed=seed)
    tcfg = TrainConfig(num_steps=TRAIN_STEPS, peak_lr=1e-3, warmup_steps=2,
                       schedule="wsd", ckpt_every=0, seed=seed)
    fresh_memory(torch)
    t0 = time.time()
    trainer = Trainer(cfg, tcfg, spec, device="cuda")
    state = trainer.init_state()
    n_params = sum(p.numel() for p in leaves(state["params"]))
    torch.cuda.synchronize()
    print(f"train {TRAIN_ARCH}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, {n_params / 1e9:.3f} B "
          f"parameters (bf16, f32 norms), f32 moments, initialised on the "
          f"card in {time.time() - t0:.1f} s", flush=True)
    zero_counters()
    losses, times = [], []
    for step in range(TRAIN_STEPS):
        batch = trainer.batch_at(step)
        torch.cuda.synchronize()
        t0 = time.time()
        state, m = trainer.train_step(state, batch)
        loss = float(m["loss"])
        times.append(time.time() - t0)
        losses.append(loss)
        print(f"train {TRAIN_ARCH} step {step}: loss {loss:.4f}, lr "
              f"{float(m['lr']):.3e}, grad norm {float(m['grad_norm']):.4f},"
              f" {1e3 * times[-1]:.1f} ms", flush=True)
    launched = {k: v for k, v in counters().items() if v}
    if launched:
        raise AssertionError(f"training launched kernels: {launched}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    steady = sorted(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = spec.global_batch * spec.seq_len
    med = steady[len(steady) // 2]
    print(f"train {TRAIN_ARCH}: {TRAIN_STEPS} steps of {tokens} tokens, "
          f"median step {1e3 * med:.1f} ms ({tokens / med:.0f} tokens/s; "
          f"the first step {1e3 * times[0]:.1f} ms), "
          f"max_memory_allocated {peak:.2f} GiB; losses "
          + " ".join(f"{x:.4f}" for x in losses), flush=True)
    batch = trainer.batch_at(TRAIN_STEPS)
    t0 = time.time()
    for _ in range(2):    # the same step again if the profiler dropped it
        if profile_steps(torch, lambda: trainer.train_step(state, batch), 1,
                         kind="training") is not None:
            break
    else:
        raise AssertionError(f"train {TRAIN_ARCH}: the profiler recorded "
                             f"no device time in two traces of a step")
    print(f"train {TRAIN_ARCH}: the profiled step and its parse took "
          f"{time.time() - t0:.1f} s", flush=True)
    del trainer, state, batch, m
    fresh_memory(torch)


def _bf16_attn_core(torch):
    """A control for ``train_step_gaps``: ``_attn_core`` with its
    products, softmax and backward in bf16, the activations' dtype."""
    import math

    def core(q, k, v, q_pos, kv_pos, *, causal, window, chunked,
             score_bf16=False):
        s = torch.einsum("bhqd,bhtd->bhqt", q.bfloat16()
                         * (1.0 / math.sqrt(q.shape[-1])), k.bfloat16())
        valid = kv_pos[:, None, None, :] >= 0
        if causal:
            valid = valid & (kv_pos[:, None, None, :]
                             <= q_pos[:, None, :, None])
        if window is not None:
            valid = valid & (kv_pos[:, None, None, :]
                             > q_pos[:, None, :, None] - window)
        p = torch.softmax(s.masked_fill(~valid, -math.inf), -1)
        return torch.einsum("bhqt,bhtd->bhqd", p, v.bfloat16()).float()
    return core


def train_step_gaps(torch, cfg, spec, tcfg, batch=None,
                    attn_control=True) -> dict:
    """One gradient step from the same parameters and batch on the card
    -- as the port computes it ("card"), with the loss's logsumexp in
    bf16 and (``attn_control``) with the attention core in bf16
    (``_bf16_attn_core``) -- and on the CPU.  The batch is the data
    pipeline's first, or ``batch`` (CPU tensors, copied to each device).
    For each card run, the relative gaps to the CPU's of the loss and the
    gradient norm, and the worst and the median leaf's relative L2
    gradient gap, printed and returned by run name."""
    from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
    from repro_torch.models import layers
    from repro_torch.optim.optimizer import global_norm
    from repro_torch.train.trainer import Trainer
    card = Trainer(cfg, tcfg, spec, device="cuda")
    params = card.init_state()["params"]
    lse = torch.logsumexp
    controls = {"card": None,
                "card with a bf16 logsumexp": (
                    torch, "logsumexp", lambda x, *a, **kw:
                    lse(x.bfloat16(), *a, **kw).float()),
                "card with a bf16 attention core": (
                    layers, "_attn_core", _bf16_attn_core(torch))}
    if not attn_control:
        del controls["card with a bf16 attention core"]

    def step(name, trainer, p, control=None):
        if control is not None:
            owner, attr, fn = control
            original = getattr(owner, attr)
            setattr(owner, attr, fn)
        t0 = time.time()
        b = trainer.batch_at(0) if batch is None else {
            k: v.to(trainer.device) for k, v in batch.items()}
        try:
            loss, grads = trainer.loss_and_grads(p, b)
        finally:
            if control is not None:
                setattr(owner, attr, original)
        out = (float(loss), float(global_norm(grads)),
               [g.float().cpu() for g in leaves(grads)])
        print(f"train {cfg.name} depth {cfg.n_layers} gradient step, {name}:"
              f" loss {out[0]:.6f}, grad norm {out[1]:.6f}, "
              f"{time.time() - t0:.2f} s", flush=True)
        return out

    runs = {name: step(name, card, params, c)
            for name, c in controls.items()}
    lh, nh, gh = step("CPU", Trainer(cfg, tcfg, spec, device="cpu"),
                      tree_map(lambda p: p.cpu(), params))
    paths = ["/".join(map(str, p)) for p, _ in leaves_with_paths(params)]
    out = {}
    for name, (lc, nc, gc) in runs.items():
        errs = {path: ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
                for path, a, b in zip(paths, gc, gh)}
        worst = max(errs, key=errs.get)
        g = out[name] = dict(
            loss=abs(lc - lh) / abs(lh), grad_norm=abs(nc - nh) / nh,
            worst_leaf=errs[worst], worst_at=worst,
            median_leaf=sorted(errs.values())[len(errs) // 2])
        print(f"train {cfg.name} depth {cfg.n_layers}, {name} vs CPU: loss "
              f"rel {g['loss']:.3g}, grad norm rel {g['grad_norm']:.3g}, "
              f"leaf gradients rel L2 worst {g['worst_leaf']:.3g} at "
              f"{worst}, median {g['median_leaf']:.3g}", flush=True)
    del card, params
    return out


def train_card_vs_cpu(torch, seed) -> None:
    """One gradient step of ``TRAIN_ARCH`` at full width and 2 layers
    (2 x 128 tokens) through ``train_step_gaps``: the card's gaps to the
    CPU held to ``TRAIN_*_TOL``; the control with a bf16 logsumexp must
    miss one of them."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataSpec
    from repro_torch.train.trainer import TrainConfig
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2)
    spec = DataSpec(vocab=cfg.vocab, seq_len=128, global_batch=2, seed=seed)
    out = train_step_gaps(torch, cfg, spec, TrainConfig(seed=seed))
    bars = {"loss": TRAIN_LOSS_TOL, "grad_norm": TRAIN_GNORM_TOL,
            "worst_leaf": TRAIN_GRAD_TOL}
    print(f"train {TRAIN_ARCH} depth 2 card vs CPU bars: {bars}", flush=True)

    def missed(name):
        return [k for k, tol in bars.items() if out[name][k] > tol]

    if missed("card"):
        raise AssertionError(f"card vs CPU training step beyond its bar: "
                             f"{missed('card')}")
    if not missed("card with a bf16 logsumexp"):
        raise AssertionError("the card vs CPU bars pass a bf16 logsumexp")
    fresh_memory(torch)


def train_restart(torch, seed) -> None:
    """``TRAIN_ARCH`` at full width and 2 layers with int8 moments on the
    card: 4 steps straight against 2 steps, a synchronous checkpoint
    (~1.6 GB), a fresh ``Trainer`` restored from it and 2 more steps
    (``Trainer.run``): the losses and every leaf of the final state
    (params, moments, scales, step) must be bit-identical.  The
    checkpoints are deleted afterwards."""
    import dataclasses
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataSpec
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2)
    spec = DataSpec(vocab=cfg.vocab, seq_len=128, global_batch=2, seed=seed)
    root = os.path.join(ROOT, "build", "train_ckpt")

    def run(name, num_steps, resume):
        tcfg = TrainConfig(num_steps=num_steps, peak_lr=1e-3, warmup_steps=2,
                           ckpt_every=0, seed=seed,
                           adamw=AdamWConfig(state_bits=8),
                           ckpt_dir=os.path.join(root, name))
        return Trainer(cfg, tcfg, spec, device="cuda",
                       async_ckpt=False).run(resume=resume)

    t0 = time.time()
    try:
        state_full, hist_full = run("straight", 4, False)
        run("resumed", 2, False)
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(os.path.join(root, "resumed"))
                   for f in fs)
        state_res, hist_res = run("resumed", 4, True)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    a, b = leaves(state_full), leaves(state_res)
    same = [x.dtype == y.dtype and torch.equal(bits(x), bits(y))
            for x, y in zip(a, b)]
    print(f"train {TRAIN_ARCH} depth 2, int8 moments: 4 steps straight "
          f"{' '.join(f'{x:.6f}' for x in hist_full)}; 2 + checkpoint "
          f"({size / 1e9:.2f} GB) + restore + 2 "
          f"{' '.join(f'{x:.6f}' for x in hist_res)}; {sum(same)} of "
          f"{len(same)} state leaves bit-identical; {time.time() - t0:.1f} s",
          flush=True)
    if hist_full[2:] != hist_res or not all(same):
        raise AssertionError("the card's restart is not bit-identical")
    del state_full, state_res
    fresh_memory(torch)


# the VLM and the enc-dec model: one card-vs-CPU gradient step at
# ``gap`` depth (layers, encoder layers), then ``steps`` training steps at
# ``depth`` (None: the config's own) on ``make_batch`` batches of
# ``batch`` x ``seq`` tokens (seamless: enc_len(seq) frames a row)
FAMILY_TRAIN = {
    "qwen2-vl-7b": dict(gap=(2, None), depth=(4, None), batch=4, seq=512,
                        steps=6),
    "seamless-m4t-medium": dict(gap=(2, 2), depth=(None, None), batch=4,
                                seq=512, steps=6)}
# card vs CPU bars of the families' step, set from tools/train_dist_probe.py
# (PERF.md §6, PR 25): the gaps it measured on the H100 were 1.38e-5,
# 6.48e-5 and 1.39e-2 (qwen2-vl-7b) and 1.13e-5, 1.61e-4 and 1.85e-2
# (seamless-m4t-medium; its worst leaf a cross-attention norm's scale);
# the bf16-logsumexp control's loss gaps 6.55e-4 and 1.45e-3
FAMILY_LOSS_TOL, FAMILY_GNORM_TOL, FAMILY_GRAD_TOL = 5e-5, 4e-4, 4e-2


def _family_cfg(arch, depth):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    n_layers, enc_layers = depth
    over = {}
    if n_layers is not None:
        over["n_layers"] = n_layers
    if enc_layers is not None:
        over["enc_layers"] = enc_layers
    return dataclasses.replace(cfg, **over) if over else cfg


def family_gaps(torch, seed, arch, bars=True) -> dict:
    """One gradient step of ``arch`` at its ``FAMILY_TRAIN`` gap depth,
    2 x 128 tokens of a ``make_batch`` train batch, through
    ``train_step_gaps`` (the card, a bf16-logsumexp control and the CPU);
    with ``bars`` the card's gaps are held to ``FAMILY_*_TOL`` and the
    control must miss one."""
    from repro_torch.data.pipeline import DataSpec
    from repro_torch.launch.specs import make_batch
    from repro_torch.train.trainer import TrainConfig
    cfg = _family_cfg(arch, FAMILY_TRAIN[arch]["gap"])
    batch = make_batch(cfg, 2, 128, "train", seed=seed, device="cpu")
    print(f"train {arch} (enc layers {cfg.enc_layers}) gradient step batch: "
          + ", ".join(f"{k} {tuple(v.shape)} {v.dtype}"
                      for k, v in batch.items()), flush=True)
    spec = DataSpec(vocab=cfg.vocab, seq_len=128, global_batch=2, seed=seed)
    out = train_step_gaps(torch, cfg, spec, TrainConfig(seed=seed),
                          batch=batch, attn_control=False)
    if bars:
        tol = {"loss": FAMILY_LOSS_TOL, "grad_norm": FAMILY_GNORM_TOL,
               "worst_leaf": FAMILY_GRAD_TOL}
        print(f"train {arch} card vs CPU bars: {tol}", flush=True)

        def missed(name):
            return [k for k, t in tol.items() if out[name][k] > t]

        if missed("card"):
            raise AssertionError(f"{arch}: card vs CPU training step beyond "
                                 f"its bar: {missed('card')}")
        if not missed("card with a bf16 logsumexp"):
            raise AssertionError(f"{arch}: the card vs CPU bars pass a bf16 "
                                 f"logsumexp")
    fresh_memory(torch)
    return out


def family_train(torch, seed, arch) -> dict:
    """``arch`` at its ``FAMILY_TRAIN`` depth trains ``steps`` steps on
    the card through ``Trainer.train_step`` (WSD: warmup 2, peak lr 1e-3;
    f32 moments; step 0 at lr 0), each on a fresh ``make_batch`` train
    batch: every loss finite, the last below the first, no K1-K7 launch;
    the median step time (the first step left out) and
    ``max_memory_allocated`` printed and returned."""
    import math
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataSpec
    from repro_torch.launch.specs import make_batch
    from repro_torch.train.trainer import TrainConfig, Trainer
    ft = FAMILY_TRAIN[arch]
    cfg = _family_cfg(arch, ft["depth"])
    spec = DataSpec(vocab=cfg.vocab, seq_len=ft["seq"],
                    global_batch=ft["batch"], seed=seed)
    tcfg = TrainConfig(num_steps=ft["steps"], peak_lr=1e-3, warmup_steps=2,
                       schedule="wsd", ckpt_every=0, seed=seed)
    fresh_memory(torch)
    trainer = Trainer(cfg, tcfg, spec, device="cuda")
    state = trainer.init_state()
    n_params = sum(p.numel() for p in leaves(state["params"]))
    print(f"train {arch}: {cfg.n_layers} decoder layers (encoder "
          f"{cfg.enc_layers}), d_model {cfg.d_model}, vocab {cfg.vocab}, "
          f"{n_params / 1e9:.3f} B parameters, f32 moments", flush=True)
    zero_counters()
    losses, times = [], []
    for step in range(ft["steps"]):
        batch = make_batch(cfg, ft["batch"], ft["seq"], "train",
                           seed=seed + 1000 * (step + 1), device="cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.time() - t0)
        print(f"train {arch} step {step}: loss {losses[-1]:.4f}, lr "
              f"{float(m['lr']):.3e}, grad norm {float(m['grad_norm']):.4f},"
              f" {1e3 * times[-1]:.1f} ms", flush=True)
    launched = {k: v for k, v in counters().items() if v}
    if launched:
        raise AssertionError(f"{arch} training launched kernels: {launched}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch} training losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} training loss did not fall: {losses}")
    steady = sorted(times[1:])
    med = steady[len(steady) // 2]
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = ft["batch"] * ft["seq"]
    print(f"train {arch}: {ft['steps']} steps of {tokens} tokens, median "
          f"step {1e3 * med:.1f} ms ({tokens / med:.0f} tokens/s; the "
          f"first {1e3 * times[0]:.1f} ms), max_memory_allocated "
          f"{peak:.2f} GiB; losses " + " ".join(f"{x:.4f}" for x in losses),
          flush=True)
    del trainer, state, batch, m
    fresh_memory(torch)
    return dict(median_ms=1e3 * med, peak_gib=peak, losses=losses)


def train_families(torch, seed) -> None:
    for arch in FAMILY_TRAIN:
        t0 = time.time()
        family_gaps(torch, seed, arch)
        family_train(torch, seed, arch)
        print(f"train {arch} took {time.time() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 7: distributed, at world size 1 over NCCL
# ---------------------------------------------------------------------------

def _same_bits(torch, a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def dist_phase(torch, seed) -> dict:
    """The distributed layer on the card at world size 1: NCCL through
    an in-process store, a ``(data, model)`` DeviceMesh of shape (1, 1)
    (and a ``(pipe,)`` one of 1).  Each check raises on a mismatch:

    * ``sharded_step`` on minicpm-2b at full width and 2 layers (2 x 128
      tokens): loss and every gradient leaf equal to the plain step's
      (``Trainer.loss_and_grads``) bit for bit;
    * ``compressed_psum`` on that step's gradients: each leaf's int8
      codes and its result equal to the CPU's (codes and dequant by
      ``compress.int8_codes`` on the CPU copy: over one rank the
      all-reduces are the identity);
    * a checkpoint of the layers' parameters restored onto the mesh
      (``restore_tree(shardings=)``): every leaf a DTensor on it, equal
      bit for bit;
    * ``pipeline_apply`` at one stage over 8 microbatches against the
      sequential product, within 1e-5.
    Returns each check's seconds."""
    import dataclasses
    import datetime
    import functools
    import shutil
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import manager as CM
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.data.pipeline import DataSpec
    from repro_torch.distributed import compress as C
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.train.trainer import TrainConfig, Trainer
    times = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0),
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2)
        spec = DataSpec(vocab=cfg.vocab, seq_len=128, global_batch=2,
                        seed=seed)
        trainer = Trainer(cfg, TrainConfig(seed=seed), spec, device="cuda")
        params = trainer.init_state()["params"]
        batch = trainer.batch_at(0)
        t0 = time.time()
        loss0, grads0 = trainer.loss_and_grads(params, batch)
        ps = S.shard_tree(params, mesh, S.shardings_for_params(mesh, params))
        bs = S.shard_tree(batch, mesh, S.shardings_for_batch(mesh, batch))
        step = S.sharded_step(functools.partial(M.loss_terms, cfg=cfg), mesh)
        loss1, grads1 = step(ps, bs)
        torch.cuda.synchronize()
        times["sharded_step"] = time.time() - t0
        same = [_same_bits(torch, g.to_local(), h)
                for g, h in zip(leaves(grads1), leaves(grads0))]
        n_sh = sum(any(not q.is_replicate() for q in p.placements)
                   for p in leaves(ps))
        print(f"dist sharded_step {TRAIN_ARCH} depth 2 on a (1, 1) mesh "
              f"({n_sh} of {len(same)} leaves with a Shard placement): loss "
              f"{float(loss1):.6f} vs plain {float(loss0):.6f}, "
              f"{sum(same)} of {len(same)} gradient leaves bit-identical, "
              f"{times['sharded_step']:.1f} s", flush=True)
        if not (_same_bits(torch, loss1.reshape(()), loss0.reshape(()))
                and all(same)):
            raise AssertionError("sharded_step is not the plain step")

        t0 = time.time()
        group = mesh.get_group("data")
        got = C.compressed_psum(grads0, group)
        n_codes = n_out = 0
        for g, out in zip(leaves(grads0), leaves(got)):
            amax = torch.max(torch.abs(g.float()))
            q, sc = C.int8_codes(g, amax)
            gc = g.cpu()
            qc, scc = C.int8_codes(gc, torch.max(torch.abs(gc.float())))
            n_codes += bool(torch.equal(q.cpu(), qc))
            want = (qc.float() * scc / 1.0).to(g.dtype)
            n_out += _same_bits(torch, out.cpu(), want)
        n = len(leaves(grads0))
        times["compressed_psum"] = time.time() - t0
        print(f"dist compressed_psum over one rank: {n_codes} of {n} "
              f"leaves' int8 codes and {n_out} of {n} results equal to the "
              f"CPU's, {times['compressed_psum']:.1f} s", flush=True)
        if n_codes != n or n_out != n:
            raise AssertionError("compressed_psum differs from the CPU's")
        del grads0, grads1, got

        t0 = time.time()
        root = os.path.join(ROOT, "build", "dist_ckpt")
        tree = {"layers": params["layers"]}
        try:
            CM.save_tree(tree, root, 1)
            shd = S.named(mesh, S.shardings_for_params(mesh, tree), tree)
            back, _ = CM.restore_tree(tree, root, shardings=shd)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        ok = [isinstance(b, DTensor) and b.device_mesh is mesh
              and _same_bits(torch, b.to_local(), a)
              for a, b in zip(leaves(tree), leaves(back))]
        times["restore"] = time.time() - t0
        print(f"dist checkpoint of {len(ok)} leaves restored onto the (1, 1) "
              f"card mesh: {sum(ok)} bit-identical DTensors, "
              f"{times['restore']:.1f} s", flush=True)
        if not all(ok):
            raise AssertionError("the restore onto the card mesh differs")
        del back, ps, bs, params, trainer

        t0 = time.time()
        pmesh = make_mesh((1,), ("pipe",))
        g = torch.Generator(device="cuda").manual_seed(seed)
        ws = torch.randn((1, 256, 256), generator=g, device="cuda") / 16
        x = torch.randn((8, 4, 256), generator=g, device="cuda")
        run = pipeline_apply(lambda w, h: torch.tanh(h @ w), 1, 8,
                             axis="pipe")
        out = run(pmesh, ws, x)
        want = torch.tanh(x @ ws[0])
        err = float((out - want).abs().max())
        times["pipeline"] = time.time() - t0
        print(f"dist pipeline_apply, 1 stage x 8 microbatches: max |out - "
              f"sequential| {err:.3g}, {times['pipeline']:.1f} s",
              flush=True)
        if not err <= 1e-5:
            raise AssertionError("pipeline_apply differs from sequential")
    finally:
        dist.destroy_process_group()
    fresh_memory(torch)
    return times


# (a) of the sharded serve step at world size 1: llama3-8b at full width
# and this depth, a prefill of SERVE_DIST_B x SERVE_DIST_S tokens, then
# SERVE_DIST_STEPS greedy decode steps
SERVE_DIST_LAYERS, SERVE_DIST_B, SERVE_DIST_S, SERVE_DIST_STEPS = 2, 4, 128, 4
# (b): the row product's card route at llama3-8b's w_down shape, its K
# words cut this many ways
ROW_SPLIT = 16


def serve_dist_phase(torch, seed) -> dict:
    """(a) the sharded serve step at world size 1 over NCCL (a (1, 1)
    ``(data, model)`` mesh on the card): llama3-8b at full width and
    ``SERVE_DIST_LAYERS`` layers, w2/a8/kv8, a prefill and greedy decode
    steps through ``sharding.sharded_serve_step``, then the same steps
    plain (``engine.prefill_step`` / ``serve_step``) from a copy of the
    caches: every step's logits and every cache leaf equal bit for bit.
    The kernel launches of the sharded steps alone are returned (the
    path's counts; the launch counters are zeroed just before them)."""
    import dataclasses
    import datetime
    import functools
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=SERVE_DIST_LAYERS)
    q = cfg.quant
    b, s = SERVE_DIST_B, SERVE_DIST_S
    max_len = s + SERVE_DIST_STEPS
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0),
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        params = M.init_params(cfg, seed=seed, device="cuda", quant=q)
        caches = M.init_caches(cfg, b, max_len, quant=q, device="cuda")
        plain_caches = tree_map(lambda t: t.clone(), caches)
        ps = S.shard_tree(params, mesh, S.shardings_for_params(mesh, params))
        cs = S.shard_tree(caches, mesh, S.shardings_for_caches(mesh, caches))
        g = torch.Generator(device="cuda").manual_seed(seed)
        toks = torch.randint(0, cfg.vocab, (b, s), generator=g,
                             device="cuda", dtype=torch.int32)
        pos = torch.arange(s, dtype=torch.int32,
                           device="cuda")[None].expand(b, s).contiguous()
        steps = [S.sharded_serve_step(functools.partial(
            fn, cfg=cfg, quant=q), mesh) for fn in (E.prefill_step,
                                                    E.serve_step)]
        t0 = time.time()
        zero_counters()
        got, batch = [], {"tokens": toks, "positions": pos}
        with torch.no_grad():
            for i in range(SERVE_DIST_STEPS + 1):
                logits, cs = steps[min(i, 1)](ps, batch, cs)
                got.append(logits)
                tok = logits[:, :cfg.vocab].float().argmax(-1).to(
                    torch.int32)[:, None]
                batch = {"tokens": tok, "positions": torch.full(
                    (b, 1), s + i, dtype=torch.int32, device="cuda")}
        torch.cuda.synchronize()
        launched = {k: v for k, v in counters().items() if v}
        t_sharded = time.time() - t0
        want, batch = [], {"tokens": toks, "positions": pos}
        caches = plain_caches
        with torch.no_grad():
            for i in range(SERVE_DIST_STEPS + 1):
                fn = E.prefill_step if i == 0 else E.serve_step
                logits, caches = fn(params, batch, caches, cfg, q)
                want.append(logits)
                tok = logits[:, :cfg.vocab].float().argmax(-1).to(
                    torch.int32)[:, None]
                batch = {"tokens": tok, "positions": torch.full(
                    (b, 1), s + i, dtype=torch.int32, device="cuda")}
        n_logits = sum(_same_bits(torch, a, c) for a, c in zip(got, want))
        mine = [t.to_local() for t in leaves(cs)]
        n_cache = sum(_same_bits(torch, a, c)
                      for a, c in zip(mine, leaves(caches)))
        print(f"serve dist sharded_serve_step llama3-8b depth "
              f"{SERVE_DIST_LAYERS} w{q.w_bits}/a{q.a_bits}/kv{q.kv_bits} "
              f"on a (1, 1) mesh: a {b} x {s} prefill and "
              f"{SERVE_DIST_STEPS} decode steps, {n_logits} of {len(got)} "
              f"steps' logits and {n_cache} of {len(mine)} cache leaves "
              f"bit-identical to the plain steps; gathered "
              f"{steps[1].gathered_bytes} B at most; {t_sharded:.1f} s; "
              f"launches {launched}", flush=True)
        if n_logits != len(got) or n_cache != len(mine) or \
                len(mine) != len(leaves(caches)):
            raise AssertionError("sharded_serve_step is not the plain step")
        for k in ("apmm_fused_linear", "flash_attention_quantized"):
            if not launched.get(k):
                raise AssertionError(f"the sharded serve step launched no "
                                     f"{k}")
    finally:
        dist.destroy_process_group()
    fresh_memory(torch)
    return launched


def row_product_phase(torch, timer, seed) -> None:
    """(b) the row product's card route at llama3-8b's ``w_down`` shape (N
    4096, K 14336, w2/a8, +residual) at M 4 and 256, fused and
    bitserial: the K words cut ``ROW_SPLIT`` ways locally, each shard
    K3-packed at the rows' scale and multiplied raw by K5, the int32
    partials summed, then the fused linear's epilogue once: equal to K1
    on the whole weight bit for bit.  Times both."""
    import dataclasses
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(seed + 29)
    n, k = 4096, 14336
    w = ops.pack_weight(torch.randn((n, k), generator=g, device="cuda"), 2)
    kw = w.packed.shape[-1]
    per = kw // ROW_SPLIT
    shards = [dataclasses.replace(w, packed=w.packed[..., i * per:(i + 1)
                                                     * per].contiguous(),
                                  shape=(n, per * 32))
              for i in range(ROW_SPLIT)]
    for m in (4, 256):
        x = torch.randn((m, k), generator=g, device="cuda").to(
            torch.bfloat16)
        res = torch.randn((m, n), generator=g, device="cuda").to(
            torch.bfloat16)
        for variant in ("fused", "bitserial"):
            def whole():
                return ops.ap_linear_fused(x, w, a_bits=8, residual=res,
                                           variant=variant)

            def split():
                scale = TP.row_scale(x, 8)
                y = None
                for i, wl in enumerate(shards):
                    part = TP.row_partial(x[:, i * per * 32:(i + 1) * per
                                            * 32], wl, scale, a_bits=8,
                                          variant=variant)
                    y = part if y is None else y + part
                return ref.linear_epilogue(y, scale, w.scale, residual=res,
                                           out_dtype=x.dtype)

            a, c = whole(), split()
            same = _same_bits(torch, a, c)
            print(f"row product {variant} w_down N={n} K={k} w2/a8 "
                  f"+residual M={m}: {ROW_SPLIT} K-shards (K3 at the rows' "
                  f"scale, raw K5, int32 sum, the shared epilogue) "
                  f"{'bit-identical to' if same else 'DIFFERS from'} K1 on "
                  f"the whole weight; {timer(split, iters=5):.4f} ms vs K1 "
                  f"{timer(whole, iters=10):.4f} ms", flush=True)
            if not same:
                raise AssertionError(f"row product {variant} M={m} is not "
                                     f"the fused linear")
    del w, shards
    torch.cuda.empty_cache()


def k6_lse_phase(torch, timer, seed, results) -> None:
    """(c) K6's lse route at llama3-8b's decode shape (K6_CASES' "decode"):
    ``o`` with the lse asked for equal to ``o`` without it bit for bit;
    the ring's two halves, each with its lse (q in f32, as the
    sequence-parallel decode runs them), combined in f32
    (``ref.combine_partials``) within 1 bf16 ulp or 1e-5 of the unsplit
    output; K6's time with and without the lse (recorded as the
    "decode lse" case)."""
    from repro_torch.kernels import flash_attention, ref
    g = torch.Generator(device="cuda").manual_seed(seed + 31)
    name, ring, window = K6_CASES[0]
    q, kv, (kq, ks, vq, vs), pos, q_pos = _ring_case(torch, g, **ring)
    kw = dict(d=128, causal=True, window=window)

    def run(lse=False, qq=q, sl=slice(None)):
        return flash_attention.flash_attention_quantized(
            qq, kq[:, sl], ks[:, sl], vq[:, sl], vs[:, sl], q_pos,
            pos[:, sl], return_lse=lse, **kw)

    o = run()
    o2, lse = run(True)
    same = _same_bits(torch, o, o2)
    t = pos.shape[1]
    parts = [run(True, q.float(), sl) for sl in (slice(0, t // 2),
                                                 slice(t // 2, t))]
    comb = ref.combine_partials(torch.stack([p[0] for p in parts]),
                                torch.stack([p[1] for p in parts])
                                ).to(o.dtype)
    ok, err, ulps = _within(comb, o)
    ms, ms_lse = timer(run, iters=20), timer(lambda: run(True), iters=20)
    dev = [sum(traced_split(torch, timer, fn, ["attention_kernel"]).values())
           for fn in (run, lambda: run(True))]
    plain = timer(lambda: ref.kv_cache_attention(
        q, kq, ks, vq, vs, q_pos, pos, return_lse=True, **kw), iters=3,
        warmup=1)
    base = results["flash_attention_quantized", name]
    verdict = "bit-identical to" if same else "DIFFERS from"
    print(f"K6 lse {name} B={q.shape[0]} H={q.shape[1]} Sq={q.shape[2]} "
          f"T={t}: o with the lse {verdict} o without; two halves combined: max|err| {err:.3g}, {ulps} "
          f"bf16 ulps beyond 1e-5 (tol 1); {ms_lse:.4f} ms with the lse, "
          f"{ms:.4f} ms without, device {dev[1]:.4f} and {dev[0]:.4f} ms "
          f"(bound {base['bound_ms']:.4f} ms by "
          f"{base['bound_by']}), plain {plain:.4f} ms", flush=True)
    if not same or not ok or not torch.isfinite(lse).all():
        raise AssertionError("K6's lse route: o differs or the split "
                             "misses its bar")
    results["flash_attention_quantized", name + " lse"] = dict(
        base, max_abs_err=err, ms=ms_lse, plain_ms=plain)


GEMMS = ("apmm_fused_linear", "apmm_fused_linear_bitserial", "apmm_packed",
         "apmm_packed_bitserial", "moe_expert_linear",
         "moe_expert_linear_bitserial")


# phase 8: the examples on the card, at small arguments
EXAMPLES = {
    "torch_quickstart.py": [],
    "torch_serve_llm.py": ["--paged", "--chunk-tokens", "8",
                           "--new-tokens", "4"],
    "torch_train_wsd.py": ["--steps", "40"],
    "torch_quantize_sweep.py": ["--steps", "20"],
}
# runs an example as ``__main__``, then prints this process's counters
_RUN_EXAMPLE = (
    "import json, runpy, sys\n"
    "path = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(path, run_name='__main__')\n"
    "from chip_smoke import counters\n"
    "print('launches ' + json.dumps(counters()))\n")


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, ROOT]))


def examples_phase(torch) -> None:
    """Each ``EXAMPLES`` script in a subprocess at its default device (the
    card): exit 0; K1, K2, K3 and K5 launch in at least one of them."""
    moved: dict = {}
    for name, args in EXAMPLES.items():
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-c", _RUN_EXAMPLE,
             os.path.join(ROOT, "examples", name)] + args, env=_env(),
            capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"example {name} exited {r.returncode}: "
                                 f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
        lines = r.stdout.splitlines()
        c = {k: v for k, v in json.loads(lines[-1][len("launches "):]).items()
             if v}
        for ln in lines[:-1]:
            print(f"  | {ln.split(chr(13))[-1]}", flush=True)
        print(f"example {name} {' '.join(args)}: exit 0 in "
              f"{time.time() - t0:.1f} s; launches {c}", flush=True)
        for k, v in c.items():
            moved[k] = moved.get(k, 0) + v
    need = {"apmm_fused_linear", "paged_attention", "quantize_pack_rows",
            "apmm_packed"}
    if need - set(moved):
        raise AssertionError(f"no example launched "
                             f"{sorted(need - set(moved))}")


# phase 8 (b): the dry run's cell functions, traced on meta over a one-rank fake
# group in a subprocess (a fake group and NCCL cannot share a process)
_DRYRUN_PROBE = (
    "import dataclasses, json\n"
    "from repro_torch.configs import get_config\n"
    "from repro_torch.launch import dryrun as D\n"
    "mesh = D.fake_mesh((1, 1), ('data', 'model'))\n"
    "cfg = dataclasses.replace(get_config('minicpm-2b'), n_layers=2)\n"
    "out = {'train': D.measure(cfg, mesh, 'train', 2, 128),\n"
    "       'serve': D.measure(D.cell_config('llama3-8b', ('kv8',)), mesh,\n"
    "                          'decode', 4, 1024)}\n"
    "print('dryrun ' + json.dumps(out))\n")
# the caching allocator hands out blocks in multiples of 512 bytes: each
# tensor of a tree may take up to this much more than its bytes
ALLOC_ROUND = 512


DRYRUN_CELL = os.path.join(ROOT, "build", "dryrun_smoke")
CARD_BYTES = 80e9          # an H100's memory
CELL_MAX_FLOPS = 3.5e14    # a rank's products in the train_4k cell


def start_dryrun() -> dict:
    """Phase 8's two host-only subprocesses, started before the examples
    so that they run beside them: the probe of (b) and the production
    cell of (c)."""
    def start(cmd):
        return subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    return {"probe": start([sys.executable, "-c", _DRYRUN_PROBE]),
            "cell": start([sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", "llama3-8b", "--shape", "train_4k",
                           "--mesh", "single", "--force", "--out",
                           DRYRUN_CELL]),
            "t0": time.time()}


def _finished(proc, what):
    out, err = proc.communicate(timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}: "
                             f"{out[-2000:]}{err[-2000:]}")
    return out


def dryrun_phase(torch, seed, procs) -> dict:
    """(b) and (c) of phase 8 on the subprocesses of :func:`start_dryrun`:
    the dry run's argument bytes against the card's allocator at world
    size 1 (a mismatch fails), its peak beside the card's, and the
    production cell's record (it must be ``ok``).  Returns the
    readings."""
    import dataclasses
    import datetime
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    log = _finished(procs["probe"], "the dry run's probe")
    meta = json.loads(log.splitlines()[-1][len("dryrun "):])
    print(f"dryrun probe on meta (one-rank fake group): done "
          f"{time.time() - procs['t0']:.1f} s after its start", flush=True)
    cases = {
        "train": (dataclasses.replace(get_config("minicpm-2b"), n_layers=2),
                  lambda cfg, mesh: D.train_state(cfg, mesh, 2, 128,
                                                  device="cuda", seed=seed),
                  lambda cfg, mesh, st: D.train_step(cfg, mesh, st)),
        "serve": (D.cell_config("llama3-8b", ("kv8",)),
                  lambda cfg, mesh: D.serve_state(cfg, mesh, 4, 1024,
                                                  "decode", device="cuda",
                                                  seed=seed),
                  lambda cfg, mesh, st: D.serve_step(cfg, mesh, st,
                                                     "decode"))}
    out = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0),
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        for kind, (cfg, build, step) in cases.items():
            fresh_memory(torch)
            m0 = torch.cuda.memory_allocated()
            state = build(cfg, mesh)
            torch.cuda.synchronize()
            got = torch.cuda.memory_allocated() - m0
            args = [state[k] for k in ("params", "opt", "batch", "caches")
                    if k in state]
            mem = meta[kind]["memory"]
            want, slack = mem["argument_bytes"], ALLOC_ROUND * D.n_tensors(
                args)
            torch.cuda.reset_peak_memory_stats()
            step(cfg, mesh, state)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - m0
            out[kind] = dict(argument=want, allocated=got, slack=slack,
                             peak=mem["peak_bytes"], card_peak=peak)
            print(f"dryrun {kind} ({cfg.name}, {cfg.n_layers} layers): "
                  f"argument_bytes {want} (param {mem['param_bytes']}, opt "
                  f"{mem['opt_bytes']}, batch {mem['batch_bytes']}, cache "
                  f"{mem['cache_bytes']}) vs memory_allocated growth {got} "
                  f"(+{got - want}, slack {slack} for {len(args)} trees); "
                  f"peak_bytes {mem['peak_bytes']} vs max_memory_allocated "
                  f"of one step {peak}: ratio "
                  f"{mem['peak_bytes'] / peak:.3f}", flush=True)
            del state, args
            if not want <= got <= want + slack:
                raise AssertionError(f"dry run {kind}: argument bytes {want}"
                                     f" vs the allocator's {got}")
    finally:
        dist.destroy_process_group()
    fresh_memory(torch)

    _finished(procs["cell"], "the production cell")
    with open(os.path.join(DRYRUN_CELL,
                           "llama3-8b__train_4k__pod256.json")) as f:
        rec = json.load(f)
    m = rec.get("memory", {})
    print(f"dryrun cell llama3-8b__train_4k__pod256: {rec['status']}, "
          f"argument {m.get('argument_bytes', 0) / 2**30:.3f} GiB, gathered "
          f"{m.get('gathered_bytes', 0) / 2**30:.2f} GiB, peak "
          f"{m.get('peak_bytes', 0) / 2**30:.2f} GiB, flops "
          f"{rec.get('flops', {}).get('total', 0):.4g}, trace "
          f"{rec.get('trace_s')} s", flush=True)
    if rec["status"] != "ok":
        raise AssertionError(f"the pod256 llama3-8b train_4k cell: "
                             f"{rec.get('error')}")
    # the sharded step's tensor-, sequence- and expert-parallel compute:
    # one layer's weights gathered at a time, a 16th of the batch shard's
    # products, a peak the card holds
    bounds = {"gathered_bytes": 2**30, "peak_bytes": CARD_BYTES}
    over = {k: m[k] for k, v in bounds.items() if not m[k] <= v}
    if rec["flops"]["total"] > CELL_MAX_FLOPS:
        over["flops"] = rec["flops"]["total"]
    if over:
        raise AssertionError(f"the pod256 llama3-8b train_4k cell is past "
                             f"its bounds: {over}")
    out["cell"] = dict(m, flops=rec["flops"]["total"])
    return out


def counters() -> dict:
    """Every kernel's launch counter, by the kernels line's names."""
    from repro_torch.kernels import apmm, flash_attention, moe, pack
    return {"quantize_pack_rows": pack.LAUNCHES,
            "apmm_fused_linear": apmm.LAUNCHES,
            "apmm_fused_linear_bitserial": apmm.BITSERIAL_LAUNCHES,
            "apmm_packed": apmm.PACKED_LAUNCHES,
            "apmm_packed_bitserial": apmm.PACKED_BITSERIAL_LAUNCHES,
            "paged_attention": flash_attention.LAUNCHES,
            "flash_attention_quantized": flash_attention.QUANTIZED_LAUNCHES,
            "flash_attention": flash_attention.FLOAT_LAUNCHES,
            "moe_expert_linear": moe.LAUNCHES,
            "moe_expert_linear_bitserial": moe.BITSERIAL_LAUNCHES}


def zero_counters() -> None:
    from repro_torch.kernels import apmm, flash_attention, moe, pack
    pack.LAUNCHES = apmm.LAUNCHES = apmm.SMALL_M_LAUNCHES = 0
    apmm.BITSERIAL_LAUNCHES = apmm.PACKED_LAUNCHES = 0
    apmm.PACKED_SMALL_M_LAUNCHES = 0
    apmm.PACKED_BITSERIAL_LAUNCHES = 0
    flash_attention.LAUNCHES = flash_attention.QUANTIZED_LAUNCHES = 0
    flash_attention.FLOAT_LAUNCHES = 0
    moe.LAUNCHES = moe.BITSERIAL_LAUNCHES = 0


@contextlib.contextmanager
def k4_rows():
    """Record each K4 call's counts while the block runs; yields a list
    that then holds (live rows, capacity rows, segment height) per call.  The counts are
    summed after the block (their sync happens here, never in the
    port)."""
    from repro_torch.kernels import moe
    kernel, seen, out = moe.moe_expert_linear, [], []

    def recording(x, a_scale, counts, *a, **kw):
        seen.append((counts, x.shape[0] * x.shape[1]))
        return kernel(x, a_scale, counts, *a, **kw)

    moe.moe_expert_linear = recording
    try:
        yield out
    finally:
        moe.moe_expert_linear = kernel
        for counts, cap in seen:
            seg = cap // counts.numel()
            out.append((int(counts.clamp(0, seg).sum()), cap, seg))


@contextlib.contextmanager
def prefix_hits(pool):
    """Record each prefix-cache hit ``pool`` (either package's paged pool)
    takes while the block runs, as (the salt it was looked up under, the
    prompt's tokens, the blocks and the tokens it reuses); yields the
    list."""
    acquire, record, salts, hits = pool.acquire_prefix, pool.record_hit, \
        {}, []

    def salted_acquire(tokens, *, salt=None):
        hit = acquire(tokens, salt=salt)
        salts[id(hit)] = salt
        return hit

    def recording_hit(hit, n_tokens):
        hits.append((salts.get(id(hit)), int(n_tokens), len(hit.ids),
                     int(hit.cached_len)))
        return record(hit, n_tokens)

    pool.acquire_prefix, pool.record_hit = salted_acquire, recording_hit
    try:
        yield hits
    finally:
        pool.acquire_prefix, pool.record_hit = acquire, record


@contextlib.contextmanager
def call_shapes(name, shape_of):
    """Record ``shape_of(*args) + (window,)`` of each call of
    ``flash_attention.<name>`` while the block runs; yields the list."""
    from repro_torch.kernels import flash_attention
    kernel, seen = getattr(flash_attention, name), []

    def recording(*a, window=None, **kw):
        seen.append((*shape_of(*a), window))
        return kernel(*a, window=window, **kw)

    setattr(flash_attention, name, recording)
    try:
        yield seen
    finally:
        setattr(flash_attention, name, kernel)


def k2_shapes():
    """K2's calls as (B, H, Gq, NB, window)."""
    return call_shapes("flash_attention_paged_quantized",
                       lambda q, *a: (*q.shape[:3], a[5].shape[1]))


def k6_shapes():
    """K6's calls as (B, H, Sq, T, window)."""
    return call_shapes("flash_attention_quantized",
                       lambda q, k_packed, *a: (*q.shape[:3],
                                                k_packed.shape[1]))


def _k6_step_shapes(label, step, shapes, want, case) -> None:
    """K6's shapes in a traced step and the ranges of ring tiles its C
    entry splits each into; phase 3's case ``case``, of (B, H, Sq, T,
    window) ``want``, must be one of them."""
    from repro_torch.kernels import flash_attention
    seen = sorted(set(shapes), key=str)
    print(f"{label} traced {step} step(s): K6 ran {len(shapes)} times, "
          f"(B, H, Sq, T, window) -> ranges: " + ", ".join(
              f"{sh} -> {flash_attention.quantized_splits(*sh[:4])}"
              for sh in seen), flush=True)
    if case is None:
        return
    if want not in seen:
        raise AssertionError(f"{label}: phase 3 times K6 at {case!r}, "
                             f"(B, H, Sq, T, window) {want}, but the traced "
                             f"{step} steps gave it {seen}")


def _k2_step_shapes(label, step, shapes, case) -> None:
    """K2's shapes in a traced step and the ranges its C entry splits each
    into; phase 3's case ``case`` (a ``K2_CASES`` name) must be one of
    them."""
    from repro_torch.kernels import flash_attention
    seen = sorted(set(shapes), key=str)
    print(f"{label} traced {step} step(s): K2 ran {len(shapes)} times, "
          f"(B, H, Gq, NB, window) -> ranges: " + ", ".join(
              f"{sh} -> {flash_attention.paged_splits(*sh[:4])}"
              for sh in seen), flush=True)
    if case is None:
        return
    _, lanes, s_q, nb, window, (_, group, _) = next(
        c for c in K2_CASES if c[0] == case)
    want = (len(lanes), group * s_q, nb, window)
    if want not in {(b, gq, nb_, w) for b, _, gq, nb_, w in seen}:
        raise AssertionError(f"{label}: phase 3 times K2 at {case!r}, "
                             f"(B, Gq, NB, window) {want}, but the traced "
                             f"{step} steps gave it {seen}")


def _k4_step_rows(label, arch, step, rows_seen) -> None:
    """K4's live against capacity rows and its segment heights in a
    traced step of ``arch``; phase 3's case for this step must be one of
    its calls."""
    live, cap, _ = map(sum, zip(*rows_seen))
    heights = sorted({seg for _, _, seg in rows_seen})
    print(f"{label} traced {step} step(s): K4 ran {len(rows_seen)} times over "
          f"{live} live rows of {cap} capacity rows ({100 * live / cap:.1f}% "
          f"live), segment heights {heights}", flush=True)
    want = K4_STEP_SEGS[arch][step][1]
    if want not in heights:
        raise AssertionError(f"{label}: phase 3 times K4's {step} step at "
                             f"seg={want}, but the traced step gave it "
                             f"heights {heights}")


def same_tokens(label, reqs, twin_tokens) -> None:
    """A bit-serial path's greedy tokens against its fused twin's (same
    weights, prompts and engine): the integer cores are exact and the
    epilogues the same code, so they must be equal token for token."""
    got = [list(r.out) for r in reqs]
    if got != twin_tokens:
        bad = [(i, next(j for j, (a, b) in enumerate(zip(x, y)) if a != b))
               for i, (x, y) in enumerate(zip(got, twin_tokens)) if x != y]
        raise AssertionError(f"{label}: tokens differ from the fused twin's "
                             f"(request, first index) {bad}")
    print(f"{label}: all {sum(map(len, got))} greedy tokens equal the fused "
          f"twin's", flush=True)


def serve_phase(torch, seed, arch, *, prompt_lens, prefix, max_len,
                n_blocks, per_dispatch, n_pack, variant="fused",
                twin_tokens=None, params=None, n_layers=None, k1_ms=None,
                late=(200,), new_tokens=32, precisions=None, w_bits=None):
    """Serve ``arch`` at full width and depth (``n_layers``: its first
    that many layers), end to end: load and
    quantize on the card (or serve ``params``, a fused path's quantized
    weights, which need no second load), then requests of
    ``prompt_lens`` tokens (the first carries a ``prefix``-token head)
    and, once the first has emitted, requests of ``late`` tokens with the
    same head (so its prefix is indexed -- a stateful stack keeps the
    prefix cache off and must see no hit), ``new_tokens`` greedy tokens
    each.  The launch counters are zeroed just before and read just
    after.  Every forward dispatch (``Engine._step``) must launch each
    kernel ``per_dispatch[name]`` times and nothing else (K3 ``n_pack``
    times in all, at load), and exactly its K1 launches at M <=
    ``apmm.small_m_max()`` must take K1's small-M route (each dispatch of
    ``tokens (B, S)`` runs its linears at M = B·S and its lm_head at M =
    B; a stateful stack's mixed step is one decode dispatch and one B=1
    dispatch per chunk lane; tied embeddings run the logits as a bf16
    matmul, not K1); every decode or fused forward makes one dispatch
    per distinct width among its lanes.  ``k1_ms(tokens, frames)``,
    where a dispatch's K1 launches vary with its kind (an enc-dec
    prefill runs the encoder and the cross K/V projections at M = the
    frames, a decode neither), gives the M of each K1 launch of a
    dispatch instead of ``per_dispatch``'s K1 entry.  A family that
    prefills whole prompts (vlm, audio) has its ``chunk_tokens``
    dropped by the engine; its traced prefill step is an admitting
    step; a traced step whose trace the profiler drops is taken again
    on a later step, and the path fails if one never came back.
    ``precisions`` (one per request, the late ones last) makes the path
    ``<arch>-nested``: one checkpoint stored at ``w_bits``, each request
    served at its own width, a metered engine; the granted widths,
    ``repro_engine_precision_total`` by width, every K1 launch of a
    dispatch at k bits on the stored stacks' top k planes in place (the
    stack's pointer plus ``w_bits - k`` planes) and exactly one prefix
    hit, the first late request's on the prefix's blocks (the index is
    salted by width), must hold, and one decode dispatch of each width
    is traced alone (K1's device ms at that width) in place of the three
    decode steps.
    ``variant="bitserial"`` serves the same
    weights through the bitserial kernels: the fused GEMM counters must
    stay 0 and the tokens must equal ``twin_tokens``, the fused run's.
    Activations at the config's own bits, a kv8 pool.  Returns the
    counts, the tokens and the quantized weights."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import apmm
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    from repro_torch.serving.paged_cache import needs_state_slots
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    stateful = needs_state_slots(cfg)
    nested = precisions is not None
    # the config's own weight bits (a nested checkpoint's: ``w_bits``),
    # activation bits, a kv8 paged pool
    quant = dataclasses.replace(cfg.quant, kv_bits=8, variant=variant,
                                w_bits=w_bits or cfg.quant.w_bits)
    name = f"{arch}-nested" if nested else arch
    label = name if variant == "fused" else f"{name}-{variant}"
    k1 = "apmm_fused_linear" if variant == "fused" \
        else "apmm_fused_linear_bitserial"
    # K1's small-M route is the fused variant's
    thr = apmm.small_m_max() if variant == "fused" else 0
    if k1_ms is None:
        head = 0 if cfg.tie_embeddings else 1    # the lm_head's K1 launch
        n_body = per_dispatch[k1] - head

        def k1_ms(tokens, frames):
            return [tokens.numel()] * n_body + [tokens.shape[0]] * head
    # every dispatch: (served bits, tokens (B, S), its launches, the
    # launches its shape makes, its small-M launches, those its M's give,
    # K1's calls); every decode or fused forward: (its lanes' widths, its
    # dispatches' bits); the widths whose next dispatch is traced alone
    dispatches, forwards, traced, trace_bits = [], [], {}, set()

    def counting_step(fn, batch, caches, q):
        tokens = batch["tokens"]
        ms = k1_ms(tokens, batch.get("frames"))
        want = {k: v for k, v in dict(per_dispatch, **{k1: len(ms)}).items()
                if v}
        before, small, bits = counters(), apmm.SMALL_M_LAUNCHES, q.serve_bits
        with k1_calls() as calls:
            if bits in trace_bits:
                trace_bits.discard(bits)
                box = []
                prof = profile_steps(
                    torch, lambda: box.append(step_fn(fn, batch, caches, q)),
                    1, kind=f"{label} decode dispatch at {bits} bits")
                if prof is not None:
                    traced[bits] = (prof, tuple(tokens.shape))
                out = box[0]
            else:
                out = step_fn(fn, batch, caches, q)
        after = counters()
        dispatches.append((bits, tuple(tokens.shape),
                           {k: v - before[k] for k, v in after.items()
                            if v != before[k]}, want,
                           apmm.SMALL_M_LAUNCHES - small,
                           sum(m <= thr for m in ms), calls))
        return out

    def grouped(fwd, lanes_of):
        def call(lanes):
            n0 = len(dispatches)
            out = fwd(lanes)
            forwards.append(([s.precision for s in lanes_of(lanes)],
                             [d[0] for d in dispatches[n0:]]))
            return out
        return call

    t_path = time.time()
    resident = fresh_memory(torch)
    # --- the main path: counters zeroed just before, read just after ---
    zero_counters()
    t0, loaded = time.time(), params is None
    if loaded:
        params = M.init_params(cfg, seed=seed, device="cuda", quant=quant)
    torch.cuda.synchronize()
    t_load = time.time() - t0
    eng = E.Engine(params, cfg, n_slots=4, max_len=max_len, quant=quant,
                   paged=True, block_size=16, n_blocks=n_blocks,
                   chunk_tokens=256, metrics=nested)
    if (eng.chunk_tokens is None) != (cfg.family in ("vlm", "audio")):
        raise AssertionError(f"{label}: chunk_tokens "
                             f"{eng.chunk_tokens} for {cfg.family}")
    step_fn = eng._step
    eng._step = counting_step
    eng._decode_forward = grouped(eng._decode_forward, lambda lanes: lanes)
    eng._fused_forward = grouped(eng._fused_forward,
                                 lambda plan: [s for s, _ in plan])
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, (prefix,), dtype=np.int32)

    def prompt(n, with_prefix):
        body = rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
        return np.concatenate([shared, body[prefix:]]) if with_prefix \
            else body

    bits = list(precisions or [None] * (len(prompt_lens) + len(late)))
    reqs = [E.Request(prompt=prompt(n, i == 0), max_new_tokens=new_tokens,
                      precision=b)
            for i, (n, b) in enumerate(zip(prompt_lens, bits))]
    lates = [E.Request(prompt=prompt(n, True), max_new_tokens=new_tokens,
                       precision=b)
             for n, b in zip(late, bits[len(prompt_lens):])]
    for r in reqs:
        eng.submit(r)
    reqs += lates
    step_ms = {"prefill": [], "decode": []}
    prof, chunk_prof, t_prof, tok_prof, n_decode = None, None, 0.0, 0, 0
    t_serve = time.time()
    with prefix_hits(eng.pool) as hits:
        while eng._has_work() or not all(r.done for r in lates):
            if reqs[0].out and getattr(lates[0], "_engine", None) is None:
                for r in lates:       # after the shared prefix is indexed
                    eng.submit(r)
            sch = eng.scheduler
            kind = "prefill" if (sch.waiting or any(
                s.prefilling for s in sch.running)) else "decode"
            n_decode += kind == "decode"
            trace_bits.clear()
            # trace one chunk step (the second) and, but on a nested path
            # (whose decode trace is a dispatch of each width, below),
            # three decode steps in the middle of the run (their times are
            # left out of the step statistics); a dropped trace is taken
            # on a later step
            traced_step = (kind == "decode" and not nested and prof is None
                           and len(step_ms["decode"]) == 8) or (
                kind == "prefill" and chunk_prof is None
                and len(step_ms["prefill"]) == 1)
            n0, tp = sum(len(r.out) for r in reqs), time.time()
            if traced_step:
                step = "decode" if kind == "decode" else (
                    "chunk" if eng.chunk_tokens else "admitting")
                with k4_rows() as rows_seen, k2_shapes() as k2_seen, \
                        k6_shapes() as k6_seen:
                    step_prof = profile_steps(
                        torch, eng.step, 3 if step == "decode" else 1,
                        kind=step)
                if k2_seen:
                    _k2_step_shapes(label, step, k2_seen,
                                    K2_STEP.get(name) if step == "decode"
                                    else None)
                if k6_seen:
                    case = K6_PATH_STEP.get(name) if step == "decode" \
                        else None
                    _k6_step_shapes(label, step, k6_seen, next(
                        ((len(lives), 16, sq, t, None)
                         for n, lives, sq, t in K6_CROSS_CASES
                         if n == case), None), case)
                if step == "decode":
                    prof = step_prof
                else:
                    chunk_prof = step_prof
                if rows_seen:
                    _k4_step_rows(label, arch, step, rows_seen)
                t_prof += time.time() - tp
                tok_prof += sum(len(r.out) for r in reqs) - n0
                continue
            # nested: from the third decode step on, each width's dispatch
            # not yet traced, alone (such steps are left out too)
            if nested and kind == "decode" and n_decode >= 3:
                trace_bits.update({s.precision for s in sch.running}
                                  - set(traced))
            tracing = bool(trace_bits)
            if not eng.step():
                break
            torch.cuda.synchronize()
            if tracing:
                t_prof += time.time() - tp
                tok_prof += sum(len(r.out) for r in reqs) - n0
            else:
                step_ms[kind].append((time.time() - tp) * 1e3)
    t_serve = time.time() - t_serve - t_prof     # traced steps left out
    counts = counters()
    small_m = apmm.SMALL_M_LAUNCHES
    # --- end of the main path ---
    rep = eng.report()
    for r in reqs:
        if r.finish_reason != "length" or len(r.out) != new_tokens:
            raise AssertionError(f"{label}: request finished "
                                 f"{r.finish_reason!r} with {len(r.out)} "
                                 f"tokens")
        if not all(0 <= t < cfg.vocab for t in r.out):
            raise AssertionError(f"{label}: token outside the vocab")
    if rep["free_blocks"] != rep["n_usable"] or rep["used_blocks"] \
            or rep.get("used_state_slots"):
        raise AssertionError(f"{label}: pool did not drain: {rep}")
    eng.pool.validate(check_contents=True)
    # stateful stacks (SSM and hybrid state, enc-dec cross caches) and
    # VLMs keep the prefix cache off
    if not eng.pool.prefix_cache and rep["prefix_hits"]:
        raise AssertionError(f"{label}: the prefix cache is off, but hit "
                             f"{rep['prefix_hits']} times")
    if eng.pool.prefix_cache and rep["prefix_hits"] < 1:
        raise AssertionError(f"the shared {prefix}-token prefix never hit")
    if cfg.window is not None and rep["window_reclaimed"] < 1:
        raise AssertionError("no block fell out of the window")
    nd = len(dispatches)
    for lanes, got in forwards:
        if len(got) != len(set(lanes)) or (nested and sorted(got) !=
                                           sorted(set(lanes))):
            raise AssertionError(f"{label}: a forward over lanes at widths "
                                 f"{lanes} made dispatches at {got}")
    total: dict = {}
    for bits_, shape, launched, want, small, want_small, _ in dispatches:
        if launched != want or small != want_small:
            raise AssertionError(f"{label}: a {bits_}-bit dispatch of tokens "
                                 f"{shape} launched {launched} ({small} "
                                 f"small-M), not {want} ({want_small})")
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v
    outside = {k: v - total.get(k, 0) for k, v in counts.items()
               if v != total.get(k, 0)}
    if outside != ({"quantize_pack_rows": n_pack} if n_pack else {}):
        raise AssertionError(f"{label}: launches outside the {nd} "
                             f"dispatches {outside}, not K3's {n_pack} at "
                             f"load")
    for k in GEMMS:
        if k not in per_dispatch and k != k1 and counts[k]:
            raise AssertionError(f"{label}: kernel {k} launched "
                                 f"{counts[k]} times, not 0")
    if small_m != sum(d[4] for d in dispatches) or (
            variant == "fused" and not 0 < small_m < counts[k1]):
        raise AssertionError(f"{label}: {small_m} of {counts[k1]} K1 "
                             f"launches on the small-M route")
    served = ""
    if nested:
        widths = sorted(set(precisions), reverse=True)
        grants = [r._tier_bits for r in reqs]
        if grants != list(precisions):
            raise AssertionError(f"{label}: widths granted {grants}")
        emitted: dict = {}
        for r in reqs:
            emitted[str(r._tier_bits)] = emitted.get(str(r._tier_bits), 0) \
                + len(r.out)
        metered = {}
        for line in eng.pool.metrics.render().splitlines():
            if line.startswith("repro_engine_precision_total{"):
                lab, val = line.split("}")
                metered[lab.split('"')[1]] = int(float(val))
        if metered != emitted:
            raise AssertionError(f"{label}: repro_engine_precision_total "
                                 f"{metered}, tokens emitted by width "
                                 f"{emitted}")
        # each K1 launch at k bits streams the stored stacks' top k planes
        stacks, top = packed_stacks(params, quant.w_bits), quant.w_bits
        for bits_, shape, _, want, _, _, calls in dispatches:
            if len(calls) != want[k1] or any(
                    n_bits != bits_ or any(p - (top - bits_) * plane
                                           not in stacks for p in ptrs)
                    for ptrs, plane, n_bits in calls):
                raise AssertionError(
                    f"{label}: a {bits_}-bit dispatch of tokens {shape} "
                    f"handed K1 {sorted({c[2] for c in calls})}-plane "
                    f"weights, not the w{top} stacks' top {bits_} planes "
                    f"in place")
        n_calls = sum(len(d[6]) for d in dispatches)
        print(f"{label}: all {n_calls} K1 launches of the {nd} dispatches "
              f"streamed the w{top} stacks' top k planes in place, k the "
              f"dispatch's width", flush=True)
        got_hits = [h for h in hits if h[2]]
        if got_hits != [(precisions[len(prompt_lens)], late[0],
                         prefix // 16, prefix)] or rep["prefix_hits"] != 1:
            raise AssertionError(f"{label}: prefix hits (salt, prompt, "
                                 f"blocks, tokens) {got_hits}, report "
                                 f"{rep['prefix_hits']}: not the first late "
                                 f"request's {prefix // 16} shared blocks "
                                 f"alone")
        by_bits = {b: sum(d[0] == b for d in dispatches) for b in widths}
        served = (f"served at {widths} bits (prompts, bits "
                  f"{[(len(r.prompt), r._tier_bits) for r in reqs]}, prefix "
                  f"hits {got_hits}, dispatches by bits {by_bits}, tokens "
                  f"by bits {emitted} = repro_engine_precision_total), ")
    for what, p in (("decode", prof), ("chunk or admitting", chunk_prof)):
        if p is None and not (nested and what == "decode"):
            raise AssertionError(f"{label}: no {what} step was traced (the "
                                 f"profiler recorded no device time on "
                                 f"every attempt)")
    if nested and set(traced) != set(precisions):
        raise AssertionError(f"{label}: traced dispatches at "
                             f"{sorted(traced)}, not one at each of "
                             f"{sorted(set(precisions))} (the profiler "
                             f"recorded no device time on every attempt)")
    if twin_tokens is not None:
        same_tokens(label, reqs, twin_tokens)
    k1_pattern = ("quantize_x_kernel|gemm_kernel|dense_chunk_kernel|"
                  "split_finish_kernel" if variant == "fused" else
                  "pack_x_kernel|apmm_bitserial_")
    for b, (p, shape) in sorted(traced.items(), reverse=True):
        k1_dev = traced_kernels(torch, p, k1_pattern)
        print(f"{label} traced decode dispatch at {b} bits, tokens "
              f"{shape}: K1 device "
              f"{sum(v[0] for v in k1_dev.values()):.3f} ms in "
              f"{sum(v[1] for v in k1_dev.values())} kernels ("
              + ", ".join(f"{k} {v[0]:.3f} ms x {v[1]}"
                          for k, v in sorted(k1_dev.items())) + ")",
              flush=True)
    n_tok = sum(len(r.out) for r in reqs) - tok_prof
    pre, dec = step_ms["prefill"], step_ms["decode"]
    counts = {k: v for k, v in counts.items() if v}
    load = (f"load+quantize {t_load:.2f} s" if loaded else
            "the fused path's quantized weights")
    print(f"end to end {label} {cfg.n_layers}L"
          f"{f' (+{cfg.enc_layers} encoder)' if cfg.enc_layers else ''} "
          f"w{quant.w_bits}/"
          f"a{quant.a_bits}{'/kv8' if eng.pool.needs_blocks else ''} "
          f"paged bs=16 chunk_tokens=256 requested, "
          f"{eng.chunk_tokens} served: {load}; {served}{len(reqs)} requests "
          f"(prompts {[len(r.prompt) for r in reqs]}, prefix hit tokens "
          f"{rep['prefix_hit_tokens']}, window-reclaimed blocks "
          f"{rep['window_reclaimed']}"
          f"{', state slots ' + str(rep['state_slots']) if stateful else ''}"
          f"), {nd} forward dispatches in {len(forwards)} decode or fused "
          f"forwards, launches "
          f"{counts} (K1 small-M route {small_m}); {n_tok} tokens outside "
          f"the traced steps in "
          f"{t_serve:.2f} s = {n_tok / t_serve:.2f} tok/s; {len(pre)} "
          f"prefill steps mean {np.mean(pre):.1f} ms, {len(dec)} decode "
          f"steps mean {np.mean(dec):.1f} ms (median {np.median(dec):.1f} "
          f"ms); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({resident:.2f} "
          f"GiB allocated before {'the load' if loaded else 'the engine'}); "
          f"the path took {time.time() - t_path:.1f} s in all", flush=True)
    tokens = [list(r.out) for r in reqs]
    del eng
    torch.cuda.empty_cache()
    return counts, tokens, params


def serve_contiguous_phase(torch, seed, *, n_layers, per_dispatch, n_pack,
                           variant="fused", twin_tokens=None):
    """llama3-8b at full width and depth ``n_layers`` served by
    ``Engine(paged=False, n_slots=4, max_len=1024)`` with the unfused
    linear (K3 + K5) and K6 reading the
    packed rings, the prompts of the paged llama path (600, 100, 300,
    then 200 once the first has emitted), 32 greedy tokens each.  The
    launch counters are zeroed just before and read just after; every
    forward dispatch must launch each kernel ``per_dispatch[name]`` times
    (K3 also ``n_pack`` times at load), and K1, K2, K4 never.
    ``variant="bitserial"`` serves through K5's bitserial kernel; its
    tokens must equal ``twin_tokens``, the fused run's.  Every counter
    not in ``per_dispatch`` must stay 0.  Returns the counts and the
    tokens."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import apmm
    from repro_torch.models import model as M
    from repro_torch.models.config import QuantConfig
    from repro_torch.serving import engine as E
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=n_layers)
    quant = QuantConfig(w_bits=2, a_bits=8, kv_bits=8, fused_linear=False,
                        variant=variant)
    label = "llama3-8b-contiguous-unfused" + (
        "" if variant == "fused" else f"-{variant}")
    forward, n_dispatch = M.forward, [0]

    def counting_forward(*a, **kw):
        n_dispatch[0] += 1
        return forward(*a, **kw)

    t_path = time.time()
    resident = fresh_memory(torch)
    M.forward = counting_forward
    # --- the main path: counters zeroed just before, read just after ---
    zero_counters()
    try:
        t0 = time.time()
        params = M.init_params(cfg, seed=seed, device="cuda", quant=quant)
        torch.cuda.synchronize()
        t_load = time.time() - t0
        n_load_pack = counters()["quantize_pack_rows"]
        eng = E.Engine(params, cfg, n_slots=4, max_len=1024, quant=quant,
                       paged=False)
        rng = np.random.default_rng(seed)      # the paged path's prompts
        shared = rng.integers(0, cfg.vocab, (128,), dtype=np.int32)

        def prompt(n, with_prefix):
            body = rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
            return np.concatenate([shared, body[128:]]) if with_prefix \
                else body

        reqs = [E.Request(prompt=prompt(n, i == 0), max_new_tokens=32)
                for i, n in enumerate((600, 100, 300))]
        late = E.Request(prompt=prompt(200, True), max_new_tokens=32)
        reqs.append(late)
        for r in reqs[:-1]:
            eng.submit(r)
        step_ms = {"prefill": [], "decode": []}
        prof, prof_admit, t_prof, tok_prof = None, None, 0.0, 0
        t_serve = time.time()
        while eng._has_work() or not late.done:
            if reqs[0].out and getattr(late, "_engine", None) is None:
                eng.submit(late)
            kind = "prefill" if eng.queue else "decode"
            # one admitting step (the second) and three decode steps
            traced = (kind == "decode" and prof is None
                      and len(step_ms["decode"]) == 8) or (
                kind == "prefill" and prof_admit is None
                and len(step_ms["prefill"]) == 1)
            if traced:
                n0, tp = sum(len(r.out) for r in reqs), time.time()
                with k6_shapes() as k6_seen:
                    if kind == "prefill":
                        prof_admit = profile_steps(torch, eng.step, 1,
                                                   kind="admitting")
                    else:
                        prof = profile_steps(torch, eng.step, 3)
                ring, window = next((c[1], c[2]) for c in K6_CASES
                                    if c[0] == K6_STEP)
                _k6_step_shapes(label, "admitting" if kind == "prefill"
                                else "decode", k6_seen,
                                (ring["b"], 8, 4 * ring["s"], ring["t"],
                                 window),
                                K6_STEP if kind == "decode" else None)
                t_prof += time.time() - tp
                tok_prof += sum(len(r.out) for r in reqs) - n0
                continue
            ts = time.time()
            if not eng.step():
                break
            torch.cuda.synchronize()
            step_ms[kind].append((time.time() - ts) * 1e3)
        t_serve = time.time() - t_serve - t_prof
        counts = counters()
        small_m = apmm.PACKED_SMALL_M_LAUNCHES
    finally:
        M.forward = forward
    # --- end of the main path ---
    for r in reqs:
        if r.finish_reason != "length" or len(r.out) != 32:
            raise AssertionError(f"request finished {r.finish_reason!r} "
                                 f"with {len(r.out)} tokens")
        if not all(0 <= t < cfg.vocab for t in r.out):
            raise AssertionError("token outside the vocab")
    rep = eng.report()
    if rep["running"] or rep["waiting"]:
        raise AssertionError(f"lanes did not drain: {rep}")
    nd = n_dispatch[0]
    for name in counts:
        per = per_dispatch.get(name, 0)
        want = per * nd + (n_load_pack if name == "quantize_pack_rows" else 0)
        if counts[name] != want or (per and counts[name] <= 0):
            raise AssertionError(f"{label}: kernel {name} launched "
                                 f"{counts[name]} times in {nd} dispatches, "
                                 f"not {per} per dispatch")
    if n_load_pack != n_pack:
        raise AssertionError(f"{label}: K3 launched {n_load_pack} times "
                             f"at load, not {n_pack}")
    if variant == "fused" and not 0 < small_m < counts["apmm_packed"]:
        raise AssertionError(f"{label}: {small_m} of "
                             f"{counts['apmm_packed']} K5 launches on its "
                             f"small-M route (decode and prefill both run)")
    if twin_tokens is not None:
        same_tokens(label, reqs, twin_tokens)
    # K5's device time in the traced steps, by kernel (its route)
    k5 = "apmm_packed_bitserial" if variant == "bitserial" else \
        "packed_to_xq|small_m::gemm_kernel|dense_chunk|split_finish"
    for what, p in (("admitting step", prof_admit),
                    ("3 decode steps", prof)):
        if p is None:
            raise AssertionError(f"{label}: the {what} went untraced (the "
                                 f"profiler recorded no device time on "
                                 f"every attempt)")
        rows = traced_kernels(torch, p, k5)
        print(f"{label}: K5 in the traced {what}: "
              f"{sum(ms for ms, _ in rows.values()):.3f} device ms in "
              + ", ".join(f"{k} {ms:.3f} ms / {n} launches"
                          for k, (ms, n) in rows.items()), flush=True)
    n_tok = sum(len(r.out) for r in reqs) - tok_prof
    pre, dec = step_ms["prefill"], step_ms["decode"]
    counts = {k: v for k, v in counts.items() if v}
    print(f"end to end {label} {cfg.n_layers}L "
          f"w2/a8/kv8 contiguous n_slots=4 max_len=1024: load+quantize "
          f"{t_load:.2f} s; {len(reqs)} requests (prompts "
          f"{[len(r.prompt) for r in reqs]}), {nd} forward dispatches, "
          f"launches {counts} (K5 small-M route {small_m}); {n_tok} tokens "
          f"outside the traced steps in "
          f"{t_serve:.2f} s = {n_tok / t_serve:.2f} tok/s; {len(pre)} "
          f"admitting steps (prefills + a decode) mean {np.mean(pre):.1f} ms, "
          f"{len(dec)} decode steps mean {np.mean(dec):.1f} ms (median "
          f"{np.median(dec):.1f} ms); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({resident:.2f} "
          f"GiB allocated before the load); the path took "
          f"{time.time() - t_path:.1f} s in all", flush=True)
    del eng, params
    torch.cuda.empty_cache()
    return counts, [list(r.out) for r in reqs]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "csrc")):
        return fail("src/repro_torch is missing: run from the repository")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    sys.path.insert(0, SRC)
    t_start = time.time()
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    from repro_torch.kernels import _build
    t0 = time.time()
    _build.build_all()
    for src, rep in sorted(_build.ptxas_reports.items()):
        lines = [ln.split("ptxas info    : ")[-1] for ln in rep.splitlines()
                 if "registers" in ln]
        print(f"build {src}: {'; '.join(sorted(set(lines)))}", flush=True)
    print(f"build: {len(_build.sources())} sources in "
          f"{time.time() - t0:.1f} s", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = Timer(torch)
    results: dict = {}
    k3_phase(torch, timer, args.seed, results)
    k1_phase(torch, timer, args.seed, results)
    k1_nested_phase(torch, timer, args.seed, results)
    k2_phase(torch, timer, args.seed, results)
    k4_phase(torch, timer, args.seed, results)
    k5_phase(torch, timer, args.seed, results)
    k7_launches = k6_k7_phase(torch, timer, args.seed, results)
    k6_cross_phase(torch, timer, args.seed, results)
    k6_lse_phase(torch, timer, args.seed, results)
    norm_phase(torch, timer, args.seed)
    print(f"kernels and the norm checked at {time.time() - t_start:.1f} s",
          flush=True)
    del timer
    torch.cuda.empty_cache()
    shallow_phase(torch, args.seed, "llama3-8b", n_layers=2, s=24)
    shallow_phase(torch, args.seed, "llama3-8b", n_layers=2, s=24,
                  contiguous=True)
    # one w8/a8 checkpoint served at its full 8 bits and at 4 and 2
    shallow_phase(torch, args.seed, "llama3-8b", n_layers=2, s=24, w_bits=8,
                  nested=NESTED_BITS)
    shallow_phase(torch, args.seed, "mixtral-8x7b", n_layers=1, s=8)
    shallow_phase(torch, args.seed, "glm4-9b", n_layers=2, s=24)
    shallow_phase(torch, args.seed, "minicpm-2b", n_layers=2, s=24)
    shallow_phase(torch, args.seed, "stablelm-3b", n_layers=2, s=24)
    # layer 0 dense (d_ff 10944), layer 1 MoE (64 experts, top 6, shared)
    shallow_phase(torch, args.seed, "deepseek-moe-16b", n_layers=2, s=24)
    # mamba2: two mamba mixers on slot 1, tied logits; jamba with
    # attn_every=2, as the reference's tests cut it: layer 0 mamba + MoE
    # (16 experts, top 2), layer 1 attention + the dense MLP
    shallow_phase(torch, args.seed, "mamba2-130m", n_layers=2, s=24)
    shallow_phase(torch, args.seed, "jamba-1.5-large-398b", n_layers=2, s=8,
                  attn_every=2)
    # seamless: 2 encoder layers on random frames, 2 decoder layers with
    # cross-attention, the cross caches on slot 1; qwen2-vl: random patch
    # embeddings and M-RoPE positions whose axes differ
    shallow_phase(torch, args.seed, "seamless-m4t-medium", n_layers=2, s=24,
                  enc_layers=2)
    shallow_phase(torch, args.seed, "qwen2-vl-7b", n_layers=2, s=24)
    print(f"card vs CPU forwards done at {time.time() - t_start:.1f} s",
          flush=True)
    # each path, then its bit-serial twin: the same quantized weights
    # (the fused path's, not a second load: the twin launches K3 no
    # time), prompts and engine, through the bitserial kernels
    paths = {}

    def pair(arch, per_dispatch, **kw):
        kw.setdefault("n_layers", SERVE_LAYERS.get(arch))
        path = arch + ("-nested" if "precisions" in kw else "")
        paths[path], tokens, params = serve_phase(
            torch, args.seed, arch, per_dispatch=per_dispatch, **kw)
        twin = {k + "_bitserial" if k in GEMMS else k: v
                for k, v in per_dispatch.items()}
        paths[path + "-bitserial"], _, _ = serve_phase(
            torch, args.seed, arch, variant="bitserial", twin_tokens=tokens,
            params=params, per_dispatch=twin, **dict(kw, n_pack=0))

    llama_kw = dict(prompt_lens=(600, 100, 300), prefix=128, max_len=1024,
                    n_blocks=257)
    pair("llama3-8b", {"apmm_fused_linear": 193, "paged_attention": 32},
         n_pack=225, **llama_kw)
    # llama3-8b-nested: one w8 checkpoint, requests at 8, 4 and 2 bits
    pair("llama3-8b", **NESTED_PATH)
    # mixtral at SERVE_LAYERS's depth: K1 4 a layer (q, k, v, o) + the
    # lm_head, K2 one a layer, K4 two; K3 at load 4 + 8 experts x 3 a
    # layer + the lm_head
    nm = SERVE_LAYERS["mixtral-8x7b"]
    pair("mixtral-8x7b", {"apmm_fused_linear": 4 * nm + 1,
                          "paged_attention": nm,
                          "moe_expert_linear": 2 * nm},
         prompt_lens=(600, 100, 300, 4300), prefix=128, max_len=4352,
         n_blocks=512, n_pack=28 * nm + 1)
    # deepseek-moe-16b (the dense layer 0, then MoE layers of 64 experts,
    # top 6, and a shared expert) and stablelm-3b (head dim 80, MHA,
    # layernorm), each at its own w3/a8 with a kv8 pool, at
    # SERVE_LAYERS's depth, with llama's prompts: K1 6 a layer + the
    # lm_head, K2 one a layer, K4 two a MoE layer; K3 at load one a weight
    # (deepseek: one an expert's)
    nd, ns = SERVE_LAYERS["deepseek-moe-16b"], SERVE_LAYERS["stablelm-3b"]
    pair("deepseek-moe-16b", {"apmm_fused_linear": 6 * nd + 1,
                              "paged_attention": nd,
                              "moe_expert_linear": 2 * (nd - 1)},
         n_pack=(nd - 1) * (4 + 64 * 3 + 3) + 7 + 1, **llama_kw)
    pair("stablelm-3b", {"apmm_fused_linear": 6 * ns + 1,
                         "paged_attention": ns},
         n_pack=7 * ns + 1, **llama_kw)
    # mamba2-130m, its 24 layers at its own w4/a8: K1 2 a layer (in_proj,
    # out_proj; the tied logits are a bf16 matmul), nothing else; K3 at
    # load one a weight.  No KV: the pool is state slots only
    pair("mamba2-130m", {"apmm_fused_linear": 48}, n_pack=48, **llama_kw)
    # jamba-1.5-large-398b's first hybrid group (layers 0-7: mamba but at
    # layer 4, MoE at 0, 2, 4, 6), w2/a8 with a kv8 pool: K1 2 a mamba
    # layer (7), 4 at the attention layer, 2 a dense MLP (4) and the
    # lm_head (27); K2 one; K4 two a MoE layer (8); K3 at load 14 + 4 +
    # 4 x 3 + 4 x 16 x 3 + 1
    pair("jamba-1.5-large-398b", {"apmm_fused_linear": 27,
                                  "paged_attention": 1,
                                  "moe_expert_linear": 8},
         n_pack=14 + 4 + 12 + 192 + 1, **llama_kw)
    # the contiguous pair at CONTIGUOUS_LAYERS layers (the run's time
    # limit): K3 and K5 7 a layer + the lm_head, K6 one a layer
    nl = CONTIGUOUS_LAYERS
    contiguous_kw = dict(n_layers=nl, n_pack=7 * nl + 1)
    paths["llama3-8b-contiguous-unfused"], contiguous_tokens = \
        serve_contiguous_phase(
            torch, args.seed,
            per_dispatch={"apmm_packed": 7 * nl + 1,
                          "flash_attention_quantized": nl,
                          "quantize_pack_rows": 7 * nl + 1}, **contiguous_kw)
    paths["llama3-8b-contiguous-unfused-bitserial"], _ = \
        serve_contiguous_phase(
            torch, args.seed, variant="bitserial",
            twin_tokens=contiguous_tokens,
            per_dispatch={"apmm_packed_bitserial": 7 * nl + 1,
                          "flash_attention_quantized": nl,
                          "quantize_pack_rows": 7 * nl + 1}, **contiguous_kw)
    # qwen2-vl-7b at SERVE_LAYERS's depth, w2/a8/kv8, M-RoPE positions,
    # whole-prompt prefill: K1 6 a layer + the lm_head, K2 one a layer;
    # K3 at load 7 a layer + the lm_head
    nq = SERVE_LAYERS["qwen2-vl-7b"]
    pair("qwen2-vl-7b", {"apmm_fused_linear": 6 * nq + 1,
                         "paged_attention": nq},
         n_pack=7 * nq + 1, **llama_kw)
    # seamless-m4t-medium at full depth, w4/a8/kv8, whole-prompt prefill:
    # a decoder layer's K1 self q, k, v, o, cross q, o, GELU up and down
    # at M = the dispatch's tokens; a prefill (frames given) adds the
    # frontend and the 12 encoder layers' 6 each, and the cross k and v
    # of each decoder layer, at M = the frames; the lm_head at M = B.  K2
    # (self) and K6 (the cross read, not causal) once a decoder layer
    # either way.  K3 at load: 6 a decoder layer, 4 a cross-attention,
    # the frontend, 6 an encoder layer, the lm_head
    from repro_torch.configs import get_config
    scfg = get_config("seamless-m4t-medium")
    nl_dec, nl_enc = scfg.n_layers, scfg.enc_layers

    def seamless_k1(tokens, frames):
        b, s = tokens.shape
        ms = [b * s] * (8 * nl_dec)
        if frames is not None:
            t = frames.shape[0] * frames.shape[1]
            ms += [t] * (2 * nl_dec + 1 + 6 * nl_enc)
        return ms + [b]

    pair("seamless-m4t-medium", {"paged_attention": nl_dec,
                                 "flash_attention_quantized": nl_dec},
         k1_ms=seamless_k1,
         n_pack=6 * nl_dec + 4 * nl_dec + 1 + 6 * nl_enc + 1, **llama_kw)
    print(f"serving paths done at {time.time() - t_start:.1f} s",
          flush=True)
    for check in (train_card_vs_cpu, train_restart, train_phase,
                  train_families):
        t0 = time.time()
        check(torch, args.seed)
        print(f"{check.__name__} took {time.time() - t0:.1f} s", flush=True)
    print(f"training done at {time.time() - t_start:.1f} s", flush=True)
    zero_counters()
    dist_phase(torch, args.seed)
    launched = {k: v for k, v in counters().items() if v}
    if launched:
        raise AssertionError(f"the distributed phase launched kernels: "
                             f"{launched}")
    # the sharded serve step and its row product
    paths["llama3-8b-sharded-serve"] = serve_dist_phase(torch, args.seed)
    timer = Timer(torch)
    row_product_phase(torch, timer, args.seed)
    del timer
    torch.cuda.empty_cache()
    print(f"distributed done at {time.time() - t_start:.1f} s", flush=True)
    procs = start_dryrun()
    try:
        examples_phase(torch)
        dryrun_phase(torch, args.seed, procs)
    finally:
        for p in (procs["probe"], procs["cell"]):
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"examples and the dry run done at {time.time() - t_start:.1f} s",
          flush=True)
    for arch, c in paths.items():
        print(f"kernels ({arch} path): "
              + ", ".join(f"{k}={v}" for k, v in c.items()), flush=True)
    meta = {
        "quantize_pack_rows": ("src/repro_torch/csrc/pack.cu",
                               "src/repro/kernels/pack.py:69"),
        "apmm_fused_linear": ("src/repro_torch/csrc/apmm_fused_linear.cu",
                              "src/repro/kernels/apmm.py:355"),
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/flash_attention.py:400"),
        "moe_expert_linear": ("src/repro_torch/csrc/moe_expert_linear.cu",
                              "src/repro/kernels/moe.py:273"),
        "apmm_packed": ("src/repro_torch/csrc/apmm_packed.cu",
                        "src/repro/kernels/apmm.py:422"),
        "flash_attention_quantized": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:234"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:124"),
        # K7's f32 route: the same pallas_call, its FFMA kernel
        "flash_attention_f32": ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:124"),
        # the bitserial variants: the same pallas_call, their own kernels
        "apmm_fused_linear_bitserial": (
            "src/repro_torch/csrc/apmm_fused_linear.cu",
            "src/repro/kernels/apmm.py:355"),
        "apmm_packed_bitserial": ("src/repro_torch/csrc/apmm_packed.cu",
                                  "src/repro/kernels/apmm.py:422"),
        "moe_expert_linear_bitserial": (
            "src/repro_torch/csrc/moe_expert_linear.cu",
            "src/repro/kernels/moe.py:273"),
    }

    def entry(k, launches, path):
        source, replaces = meta[k]
        base = k.removesuffix("_bitserial").removesuffix("_f32")
        arch = path and path.removesuffix("-bitserial")
        case = PATH_CASES.get(arch, {}).get(base, SHARED_CASES[base])
        r, extra = results[k, case], dict(path=path, case=case)
        if "fused_ms" in r:           # the fused kernel's time, this run
            extra["fused_ms"] = r["fused_ms"]
        return dict(name=k, **extra, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])

    # one entry per (path, kernel): ``launches`` is that path's own count,
    # the rest its phase-3 case at that path's shape (``PATH_CASES``); K7
    # is on no path (as in the reference): its launches are phase 3's, by
    # route
    kernels = [entry(k, counts[k], arch)
               for arch, counts in paths.items() for k in meta
               if counts.get(k)]
    kernels += [entry(k, n, None) for k, n in k7_launches.items()]
    if {e["name"] for e in kernels} != set(meta):
        raise AssertionError("a kernel is missing from the kernels line")
    print(f"events the profiler lost: {PROFILER_DROPS}", flush=True)
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
