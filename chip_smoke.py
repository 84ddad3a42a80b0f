#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port on one CUDA card: its main paths,
ReID retrieval serving (int8 and fp32 modes), IVF shortlist serving, the
FedSTIL federated round (stacked engine, device evaluation), the same
round with the ``delta+topk`` wire codec, on the host engine, and with the
``topk+int8`` wire codec, the paper's Table II baselines (the strategy
zoo), the round on the sharded engine (a world of one), the dense LM's
FedSTIL edge train step (qwen3-1.7b at full width), LM decode serving
with its bf16 / int8 KV cache and ring window, the LM's sharded steps
on a world of one (``launch/steps.py``), and the moe, ssm and hybrid
families (plus vlm and encdec, reduced).

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --only lm_scaleout    # some groups of phases

``--only`` takes groups of phases, comma-separated (``ONLY_GROUPS``: the
kernels, serving, the rounds, lm_train, lm_decode, lm_scaleout,
lm_families), with the groups each needs; its last line carries the
groups, and it prints no kernels line (not every path ran).

Phases, each printing one JSON line; any failure exits nonzero. Every
federated run that reports stage ms is traced (``run_simulation(...,
trace=obs.Tracer())``): its stages are the telemetry spans:

  1. device      torch's card name and ``nvidia-smi``'s name + power limit
                 (no CUDA device -> exit 1, no result)
  2. build       nvcc builds of every kernel of both paths (seconds)
  3. kernels     each CUDA kernel against its plain PyTorch version on the
                 card, at the main paths' shapes and at ragged ones:
                 quantize bit-identical, distances within 1e-5, KL
                 similarity within 2e-6, normalized relevance within 1e-6
                 and aggregated bases within 2e-5 (both aggregate entries at
                 the round's and the fleet's shapes, R of 1, 127, 129 and
                 1001, K = C off the 32-deep step, ragged P, misaligned
                 bases: all three variants, skinny, tiled and ragged; an
                 all-zero W and a NaN diagonal at C = 6 and 1000; their
                 tile kernels spill nothing; the normalize entry's Wn
                 within 1e-6 and bit for bit the fused entry's at C = 1
                 to 1001), IVF cluster distances and
                 shortlist scores within 1e-5 (shortlist ids equal, ragged
                 shapes with an empty bucket and an all-invalid client);
                 the codec's grouped top-k pack / unpack and index bit-pack
                 / unpack, and the path's encode (pack + bit-pack) and
                 decode (bit-unpack + unpack) launches, equal to theirs
                 (values under ==, NaN where theirs is, indices and bytes
                 bit for bit) at the round's, the fleet's and ragged
                 shapes, with ties, zeros, an all-zero row, NaN and
                 infinities, the decode on malformed planes bit for bit
                 against the one-stage bit-unpack and unpack (encode and
                 decode timed at the round's and the fleet's shapes beside
                 the two launches each replaces); the int8 decode
                 (dequantize + bit-unpack + unpack) bit for bit against its
                 plain version and against dequantize then decode, planned
                 and under both per-thread variants, at the round's and the
                 fleet's payloads and ragged ones (code rows off 16 bytes,
                 chunks 256 / 100 / 7, groups 6 / 8 / 16, NaN and infinite
                 scales, a misaligned code base, malformed planes), timed
                 at both path shapes beside its plain version and the two
                 launches it replaces; dequantize
                 and the adaptive combine bit-identical, the host server's
                 plain aggregate within 2e-5, the 2-D distances within
                 1e-5 (the codec's K with its tail chunk, misaligned bases,
                 ragged leaves and shapes), the bf16 combine bit-identical
                 (the LM head's and MLP's leaves, misaligned); the four
                 flash-attention kernels (forward, forward + logsumexp, dQ,
                 dK/dV) in fp32 at edge shapes (S 16 / 1000 / ragged, hd 64
                 and 128, R 1 and 2, non-causal Sq != Sk, a window: o 2e-5,
                 lse 1e-5, grads 5e-4) and in bf16 at the train step's
                 shape (each element within one bf16 rounding, relative L2
                 1e-3, lse 1e-4), timed there beside
                 ``scaled_dot_product_attention`` and its backward (whose
                 own readings against the plain versions are reported); all
                 four in bf16 (the tensor-core kernels, HGMMA in their
                 SASS) also at the edge shapes, rows that see no key o = dQ
                 = 0 with lse -1e30, kv rows that no query sees dK = dV = 0;
                 times (CUDA events, median of 30 launches after warmup),
                 the relevance, codec, dequantize, aggregate and combine
                 kernels at the C = 1000 shapes; both aggregates also at
                 the round's shapes (fused C = 5 at P = 37696 and 57664,
                 plain R = 3 and 5 of C = 5) and the fused one at C = 100,
                 each beside torch.mm and its bound, and both forced onto
                 the skinny and the tiled variant at C = 5 to 32 (the sweep
                 that sets the skinny one's largest C); kl_similarity at
                 its edges (D 37 / 128 / 130, N 1 / 129, M 767, misaligned
                 bases), both its variants forced at C = 5, 100 and 1000
                 (outputs equal bit for bit; timed: the sweep that sets
                 SPLIT_MIN_TILES), one device kernel for a call at C = 5
                 (torch.profiler), timed at C = 5 and 100 beside its bound;
                 the quantizer at its edges (chunks 16 to 1024, K = 14136
                 and 21624, P % 4 != 0, misaligned bases; each edge's
                 variant reported) and timed at the codec's path shapes;
                 neither library spills; the four distance entries at
                 their edges (B 1 / 65 / 129, G 1 / 255 / 257 / 1000, fp32
                 F 64 / 40 / 37, int8 F 64 / 48 / 40, bases off 16 bytes)
                 under both variants of their ``_plan``, tile and ragged
                 (each within 1e-5, the two bit for bit equal), timed at
                 the path shapes (serving int8 and fp32, the round's
                 evaluation) under each variant beside baddbmm and their
                 bounds; their libraries hold FFMA, no HMMA / HGMMA, no
                 spills; the combine (``adaptive_combine_tree``, one launch
                 per dtype group of a tree) bit-identical on single leaves
                 (ragged, misaligned, fp32 and bf16), the round's head (C =
                 5 and a stack of one, aligned and through
                 ``offset_copy``), the LM's full-width bf16 tree, a mixed
                 fp32 / bf16 tree with ragged, misaligned and empty leaves
                 (two launches) and a tree past MAX_LEAVES (three), its
                 ``_foreach_mul`` gradients bit-identical to autograd's of
                 ``b * al + a``; timed on the head beside seven one-leaf
                 launches, the plain version and ``torch._foreach_addcmul``,
                 with the host microseconds of a ``combine()`` call against
                 the leaf-by-leaf path's, and on the LM's tree and single
                 large leaves
  4. serve_int8  C=4 clients x G=131072 clustered gallery rows (the
                 8 MiB/client int8 budget), int8 engine, batch 64, 512
                 closed-loop queries with a head update at mid-stream
  5. serve_fp32  the same at G=32768 (the fp32 budget) with fp32 rows kept
  6. parity      served answers vs an engine built on the plain versions on
                 the card, fp32 vs the numpy host oracle, int8-vs-fp32
                 full-ranking mAP delta, and every kernel's launch count
                 during phases 4-5 (counts are zeroed just before phase 4)
  7. serve_breakdown  device time of each stage of one full query launch
                 (featurize, score, rank, readback) beside its host wall time
  7b. serve_ivf  the IVF shortlist path at C=4, G=131072 (nlist "auto" =
                 512, bcap 384, nprobe 8): 512 closed-loop queries with a head
                 update at mid-stream (QPS, p50, p99, the update's k-means
                 refresh ms), kernel launches counted over it alone and each
                 kernel held against its plain version on the operands of
                 its last call; then (``serve_ivf_checks``) served answers vs
                 an engine on the plain versions and vs the numpy oracle,
                 recall@10 against the exact int8 path on the same index at
                 nprobe 4 / 8 / 16 (>= 0.95 at 8, the serve bench's gate)
                 and the QPS ratio to serve_int8, the
                 ``ivf_metrics`` of one launch, two refreshes under one head
                 bit-identical, and a full probe (nprobe = nlist) returning
                 the exact int8 path's ids at G=8192; and its breakdown
  8. round_fedstil  the federated round: ``run_simulation(FedSTIL(C=5),
                 FederatedReIDBenchmark(), rounds=60)`` on the card (T=6
                 tasks, 5 epochs, batch 64, eval every 2 rounds), per-eval-
                 round mAP/R1/R5/forgetting, bytes, per-round wall and
                 stage ms; the same run on the CPU (the plain versions) and
                 their agreement; the launches of the round's kernels
                 (counts zeroed just before the card run; the combine one
                 launch a combine); each of them
                 against its plain version on the operands of its last
                 call in the card run (tolerances of phase 3); then each
                 round's stage ms (``round_fedstil_stages``). The full
                 per-round tables of both runs go to
                 ``build/round_fedstil.json``.
     serve_round_heads: the round's final heads serve its evaluation
                 galleries (``RetrievalEngine.from_eval_cache``, int8), 64
                 queries per client, against the plain-version engine
     round_profile: six more rounds on the card under torch.profiler:
                 device kernels and copies per round, their summed device
                 time, and the device's idle share of the profiled window
     round_fedstil_codec: the same protocol with the ``delta+topk`` wire
                 codec on both directions (``FedSTIL(..., codec=
                 "delta+topk")``), on the card and on the CPU: per-eval-
                 round metrics, card-vs-CPU final mAP / R1 (<= 0.03, beside
                 the card run's own change under a one-ulp nudge of one
                 initial weight) and per-round wire bytes (equal),
                 ``comm_breakdown()`` totals
                 wire against formula, the measured reduction and the mAP
                 difference against round_fedstil (reported, not gated),
                 the codec's encode and decode launches, once each a
                 residual payload (118; counts zeroed just before the card
                 run; checked against the count the run's own comm rows
                 give), none of the four one-stage codec kernels, encode
                 and decode each against its plain
                 version on its last on-path operands and timed there
                 beside its bound (so does round_fedstil_codec_int8, with
                 quantize, the int8 decode and dequantize), and the
                 encode_c2s / encode_s2c stage ms. Per-round tables go to
                 ``build/round_fedstil_codec.json``.
     round_fedstil_host: round_fedstil's protocol and initial weights on
                 the host engine (``engine="host"``, one client at a time,
                 the relevance tracker, ``personalized_aggregate``): per-
                 eval-round and final mAP / R1 against round_fedstil's card
                 run (<= 0.01), equal bytes, round 0's normalized W within
                 1e-5, the launches of its kernels (relevance_aggregate once
                 a round with relevant rows, kl_similarity once a round,
                 batched_pairwise_dist once an eval, adaptive_combine once a
                 combine and client), each held against its plain version
                 on its last on-path operands, and the stage ms
     round_host_variants: four-round runs of the slice's other host paths on
                 the card: FedSTIL with host evaluation against device
                 evaluation, STL and FedAvg host against stacked, FedSTIL
                 host with the numpy ``topk+int8`` codec against the CPU,
                 and the stacked round under ``int8``, ``bf16``,
                 ``delta+topk+bf16`` and FedAvg ``int8`` against the CPU
                 (equal bytes, metrics within 0.03)
     round_fedstil_codec_int8: round_fedstil's protocol with ``topk+int8``
                 on the stacked engine on the card: wire bytes at the
                 prediction from the shapes, batched_quantize once a
                 payload (120), batched_dequantize once a dense keyframe
                 (2), encode and the int8 decode (dequantize + bit-unpack
                 + unpack in one launch) once a residual payload (118),
                 neither the fp32 decode nor the four one-stage codec
                 kernels, each kernel against
                 its plain version on its last on-path operands, the coded
                 minus the uncoded final mAP; then 4 rounds of the same on
                 the card and on the CPU: equal wire bytes, final mAP / R1
                 within 0.03; per-round tables in
                 ``build/round_fedstil_codec_int8.json``
     round_zoo:  the Table II baselines at ``benchmarks/common.py``'s
                 settings (epochs 4): EWC, MAS, iCaRL (raw-image
                 exemplars re-encoded on the card), FedProx, FedCurv and
                 FedWeIT (a) l1 1e-4 / l2 1e-6 and (b) 5e-6 / 1e-3 on the
                 host engine, on the paper's bench (C=5, T=6, the edge
                 model's widths) for 6 rounds (one a task; the protocol's
                 60 cut), evaluated every 2 rounds, on the card; then 2
                 rounds (tasks 1-2) of each on the card and on the CPU:
                 per-eval-round mAP / R1 / forgetting, every eval round's
                 mAP / R1 card vs CPU within 1e-4,
                 C2S / S2C / storage bytes equal (FedWeIT: up to the
                 exact ties at its top-30% threshold, counted per
                 upload), round wall and stage ms (medians); FedProx also
                 on the stacked engine on the card, every eval round
                 within 1e-4 of its host run, with equal bytes;
                 batched_pairwise_dist once an evaluation (24) and no
                 other kernel (counts zeroed just before the card runs),
                 held against its plain version on its last on-path
                 operands. Per-round tables in ``build/round_zoo.json``
     round_sharded: the sharded engine (``engine="sharded"``) on a world
                 of one (NCCL): round_fedstil's protocol with the float32
                 wire against round_fedstil's card run (every eval round's
                 mAP / R1 within 1e-4, bytes equal, round 0's Wn within
                 1e-6; kl_similarity, batched_pairwise_dist and the
                 combine launched as there, Wn on normalize_relevance and
                 Eq. 6 on relevance_aggregate once a round each, never
                 the fused entry), with the default
                 bf16 wire (bytes equal, final mAP / R1 within 0.01), and
                 with topk+int8 against round_fedstil_codec_int8's card
                 run (every round's bytes equal, final within 0.03), each
                 kernel of the path against its plain version on its last
                 operands; the sharded aggregate at C = 5, 100 and 1000
                 against the fused kernel (B within 2e-5, Wn within 1e-6,
                 bit-equality reported) with both times, the server round
                 sharded and stacked (host wall, peak bytes), fed_round on
                 the one-rank mesh; a traced sharded run's events equal to
                 the stacked engine's. Per-round tables in
                 ``build/round_sharded.json``
  9. server_round_scale  the stacked server step alone (ring push, KL
                 relevance, flatten, fused aggregate, unflatten) at C=100
                 and C=1000, P=57664, D=128, k=6: device ms of each stage
 10. wire_round_scale  ``BatchedCodec.roundtrip`` of a (C, 57664) payload
                 under ``delta+topk`` and ``topk+int8`` at C=100 and C=1000
                 past the keyframe: device ms of encode, decode (topk+int8:
                 also the int8 decode, quantize and dequantize), the four
                 one-stage kernels and the whole roundtrip, the
                 roundtrip's peak memory untraced and under a tracer (the
                 encode's metrics), wire bytes a client against the dense
                 230656
     telemetry:  what tracing costs: the stacked server round's tracing tax
                 at C=100 (benchmarks/server_round.py's measure: null
                 tracer against a live one, min of 3 x 8 rounds; reported
                 against its 2% rule), the null hooks' host cost times the
                 hooks of a stacked round as a share of the untraced
                 round's wall (fails at 2% or more), the protocol's stacked
                 round untraced and traced for 6 rounds each, twice (round
                 wall of each; no span sync and no torch.cuda.synchronize
                 untraced, counted), the traced run's phase shares and its
                 Chrome trace written to build/ and read back, and the
                 codec roundtrip's peak at C=1000 both ways
 11. lm_train    the FedSTIL split step of ``launch/train.py``
                 (``make_train_step``, tie_lambda 1e-4, Adam with the cosine
                 schedule) on qwen3-1.7b at full width (28 layers, d 2048,
                 16 q / 8 kv heads, hd 128, bf16, seed-0 random weights),
                 B=2 x S=4096 (train_4k's sequence; its global batch of 256
                 cut to one card's 2): one warm-up and three timed steps
                 (CUDA events: step ms, tokens/s, peak memory), flash
                 launches checked at 27 / 1 / 1 / 1 a step, all on the
                 tensor cores (counts zeroed just before),
                 the combine once a dtype a step, each flash
                 kernel against its plain version on its last on-path
                 operands, and the first step's loss and adaptive gradients
                 with attention routed to the plain versions on the card
                 (|loss delta| <= 2e-2, relative L2 <= 2e-2); one more step
                 under torch.profiler: device ms by kernel group, idle
                 share
     lm_roofline lm_train's step priced against the H100's roofline
                 (``sharding/analysis.py``): one step counted on the card
                 (``OpCounter``; flash 27 / 1 / 1 / 1, counts zeroed just
                 before) and on meta tensors, FLOPs equal; three timed
                 steps' median beside t_compute (counted FLOPs / 989
                 TFLOP/s) and t_memory (the analytic model's HBM bytes /
                 3.35 TB/s), the roofline share and the MFU; the step's
                 peak above what was held beside the meta estimate; a
                 bf16 8192^3 mm's rate and a 1 GiB copy's bandwidth
                 beside the constants; ``python -m
                 repro_torch.launch.dryrun`` on qwen3-1.7b train_4k at 16 x
                 16 and 2 x 16 x 16 (started in the background at the
                 script's start) ending with failures=0
     lm_train_reduced: the GQA-reduced config (R = 2, hd 64, fp32) trained
                 10 steps on the card and on the CPU, B=4 x S=200, per-step
                 loss within 1e-4, every stage on the FMA kernels; then one
                 full fine-tuning step on both (forward + lse, dQ and dK/dV
                 on every layer)
 12. lm_decode   decode serving (``decode_step``, ``launch/serve_lm.py``)
                 on qwen1.5-0.5b whole (24 layers, d 1024, 16 / 16 heads,
                 vocab 151936): the reference's decode-equals-forward gate
                 in fp32 params at B 4 x S 64 (fp32 and int8 caches,
                 agreement >= 0.95; the forward on the fp32 flash kernel,
                 decode on none), the same in bf16 params (agreement and
                 the decode-vs-forward logits' relative L2), ``serve_lm
                 --full-model`` (B 4, prompt 16, gen 32), then the median
                 ms of 20 decode steps beside their bound (weights + cache
                 read once at 3.35 TB/s): decode_32k's 32768-slot cache at
                 B 8 (its 128 cut to fit) in bf16 and int8, long_500k's
                 ring (B 1, window 8192, pos 524287), and the bf16 32k
                 step's device ms by kernel group (torch.profiler)
     lm_scaleout the LM's sharded steps (``launch/steps.py``) on a world
                 of one over NCCL, on the models lm_train and lm_decode
                 hold: qwen3-1.7b's train step at lm_train's state and
                 batch through ``build_train_step`` on
                 ``make_production_mesh(model=1)``, layouts "tp" and "dp",
                 one SGD(lr = 1) step each against lm_train's unsharded
                 step from the same state (loss and every adaptive
                 gradient leaf as old - new: bit for bit, else relative
                 L2 <= 1e-3), 1 warm-up + 3 timed steps (CUDA events)
                 beside lm_train's, flash launches 27 / 1 / 1 / 1 a step;
                 qwen1.5-0.5b at lm_decode's gate shape (B 4 x S 64):
                 ``build_prefill_step`` and 8 ``build_decode_step`` steps
                 in bf16 and int8 caches, then with FSDP and
                 weight-stationary decode, tokens and caches bit for bit
                 the unsharded ``decode_step``'s in every mode, each
                 step's host ms beside the unsharded step's
 13. lm_families the LM zoo at full width: rwkv6-1.6b and zamba2-2.7b
                 whole, qwen3-moe-235b-a22b cut to 2 trunk + 1 adaptive
                 layers of 94: each one's fp32 decode-equals-forward gate
                 (B 2 x S 32, >= 0.95), a bf16 decode step's ms at B 8 (a
                 4096-slot cache; rwkv's O(1) state) beside its bound, the
                 rwkv and mamba time loops' ms, and for rwkv6 and zamba2
                 one full-width split train step (finite loss, trainable
                 tree changed; zamba2's 9 shared-attention calls on the
                 tensor-core flash kernels at its head dim 80, padded);
                 then the split train step of every registered arch
                 reduced, and of the vlm and encdec variants, 3 steps on
                 the card and on the CPU (per step |delta loss| <= 1e-4).
                 Flash launches are checked a forward and a step

then the script's wall time, the ``{"kernels": [...]}`` line, the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.comm.batched import BatchedCodec  # noqa: E402
from repro_torch.comm.codec import make_codec  # noqa: E402
from repro_torch.common.pytree import (flatten_stacked,  # noqa: E402
                                       leaf_paths, tree_leaves, tree_map,
                                       unflatten_stacked)
from repro_torch.configs import (ARCH_IDS, LONG_CONTEXT_WINDOW,  # noqa: E402
                                 get_config, get_shape)
from repro_torch.core import edge_model as EM  # noqa: E402
from repro_torch.core.adaptive import combine, split_params  # noqa: E402
from repro_torch.core.fedstil import (FedSTIL,  # noqa: E402
                                      sharded_fused_aggregate)
from repro_torch.core.relevance import ring_push, ring_relevance  # noqa: E402
from repro_torch.data import FederatedReIDBenchmark  # noqa: E402
from repro_torch.data.tokens import synthetic_lm_batch  # noqa: E402
from repro_torch.federated import (FedAvg, FedCurv, FedProx,  # noqa: E402
                                   FedWeIT, run_simulation)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ref as REF  # noqa: E402
from repro_torch.kernels import adaptive_combine as ACM  # noqa: E402
from repro_torch.kernels.adaptive_combine import (  # noqa: E402
    adaptive_combine, adaptive_combine_tree)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_dkv, flash_attention_dq, flash_attention_fwd,
    flash_attention_fwd_lse)
from repro_torch.kernels.int8_dist import batched_int8_pairwise_dist  # noqa: E402
from repro_torch.kernels.ivf import (batched_cluster_dist,  # noqa: E402
                                     batched_ivf_shortlist_scores)
from repro_torch.kernels import int8_dist as I8M  # noqa: E402
from repro_torch.kernels import ivf as IVFM  # noqa: E402
from repro_torch.kernels import kl_similarity as KLM  # noqa: E402
from repro_torch.kernels.kl_similarity import kl_similarity  # noqa: E402
from repro_torch.kernels import pairwise_dist as PD  # noqa: E402
from repro_torch.kernels.pairwise_dist import (  # noqa: E402
    batched_pairwise_dist, pairwise_dist)
from repro_torch.kernels import quantize as QZ  # noqa: E402
from repro_torch.kernels.quantize import (  # noqa: E402
    batched_dequantize, batched_quantize)
from repro_torch.kernels import relevance_aggregate as RA  # noqa: E402
from repro_torch.kernels.relevance_aggregate import (  # noqa: E402
    fused_relevance_aggregate, normalize_relevance, relevance_aggregate)
from repro_torch.kernels import topk_pack as TP  # noqa: E402
from repro_torch.kernels.topk_pack import (batched_idx_bitpack,  # noqa: E402
                                           batched_idx_bitunpack,
                                           batched_topk_decode,
                                           batched_topk_decode_int8,
                                           batched_topk_encode,
                                           batched_topk_pack,
                                           batched_topk_unpack)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import fed_round as FR  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.launch import steps as STEPS  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.serve import stacked_heads  # noqa: E402
from repro_torch.lifelong import EWC, ICaRL, MAS, STL  # noqa: E402
from repro_torch.models import layers as LMLAYERS  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as MOEM  # noqa: E402
from repro_torch.models import rwkv as RWKVM  # noqa: E402
from repro_torch.models import ssm as SSMM  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs import trace as obs  # noqa: E402
from repro_torch.serving import (ContinuousBatcher, GalleryIndex,  # noqa: E402
                                 RetrievalEngine, map_from_ranked_ids,
                                 query_ivf, query_ivf_host, recall_at_k,
                                 run_closed_loop)
from repro_torch.serving.engine import (featurize, rank_shortlist,  # noqa: E402
                                        rank_topk)
from repro_torch.serving.index import index_features  # noqa: E402
from repro_torch.sharding import analysis as AN  # noqa: E402
from repro_torch.sharding import specs as SH  # noqa: E402
from repro_torch.sharding.analytic import analytic_roofline  # noqa: E402
from repro_torch.train.optimizer import (adam, apply_updates,  # noqa: E402
                                         cosine_schedule, sgd)
from repro_torch.train.trainer import (  # noqa: E402
    adaptive_loss_and_grads, init_opt_state, init_train_state,
    make_full_train_step, make_train_step, train_state_from_params)

SEED = 0
C, BATCH, K, N_QUERIES = 4, 64, 10, 512
CFG = EM.EdgeModelConfig()
F = CFG.feat_dim
BUDGET_BYTES = 8 << 20                   # per-client gallery feature budget
G_INT8 = BUDGET_BYTES // F               # 131072 int8 rows
G_FP32 = BUDGET_BYTES // (4 * F)         # 32768 fp32 rows
N_PER_ID, ID_RANK, ID_RHO = 8, 16, 0.22  # clustered gallery recipe
N_HOST = 32                              # queries per client vs numpy oracle
N_MAP = 64                               # queries per client for the mAP delta
NPROBE, NPROBE_SWEEP = 8, (4, 8, 16)     # IVF buckets scored per query
IVF_MIN_RECALL = 0.95    # recall@10 vs exact int8 at NPROBE: the serve
                         # bench's gate (benchmarks/serve_bench.py:71-74)
N_RECALL = 128                           # queries per client, ivf recall@10
G_FULL_PROBE = 8192                      # full probe vs exact int8 (time)
N_ROUND_SERVE = 64                       # queries per client on round heads
IVF_OPS = ("batched_cluster_assign", "batched_ivf_shortlist")

DIST_TOL = 1e-5        # kernel vs plain: fp32 sums over F=64 in another order
SERVE_DIST_TOL = 1e-4  # served distances vs plain engine / numpy oracle
MIN_RECALL = 0.999
MAP_TOLERANCE = 0.01   # int8-vs-fp32 full-ranking mAP delta
KL_TOL = 2e-6          # kernel vs plain; S in (0, 1], log-D-shifted fp32 sums
WN_TOL = 1e-6          # normalized relevance, entries in [0, 1]
AGG_TOL = 2e-5         # bases B at standard-normal Theta, K = C fp32 sums

# the federated round (the paper's protocol) and the server-step scale
ROUNDS, N_CLIENTS = 60, 5
ROUND_W_TOL, ROUND_B_TOL = 1e-5, 1e-4   # card vs CPU, round 0
ROUND_METRIC_TOL = 0.01                 # card vs CPU, final round mAP / R1
# card vs CPU, final round mAP / R1 of the coded round: its trajectory
# amplifies last-bit differences (a one-ulp nudge of one initial weight
# moves the final mAP and R1 by ~0.01; the phase measures it on the card,
# ``one_ulp_sensitivity``), so no two implementations that differ in the
# last bit hold 0.01 there. 0.03 is the reference's own codec fidelity
# margin (tests/test_comm_codec.py:236). ROADMAP, Queue 3.
CODEC_METRIC_TOL = 0.03
HIST_K, SCALE_CLIENTS = 6, (100, 1000)
P_EDGE = 57664                          # EdgeModelConfig() head, 512 classes
P_ROUND = 37696                         # the round's head: the bench's 200 ids
# the aggregates' edges for correctness (fused (C, P), plain (R, C, P)):
# the path shapes, R of 1, 127, 129 and 1001 around the 128-row tile, K =
# C off the 32-deep k step, ragged P (1001, 333), each aligned P again on a
# misaligned base; and their timed shapes (the round's, the edge model's
# head, the fleet's C = 100 and 1000)
AGG_FUSED_EDGES = ((5, P_EDGE), (5, P_ROUND), (100, P_EDGE), (7, 1001),
                   (32, 1000), (33, 1000), (33, 1001), (127, 333),
                   (129, P_ROUND), (1001, 1000))
AGG_PLAIN_EDGES = ((3, 5, P_ROUND), (5, 5, P_EDGE), (1, 7, 1001),
                   (20, 30, 1000), (70, 100, 333), (1, 100, P_EDGE),
                   (127, 200, 1000), (129, 129, 333), (1001, 1001, P_ROUND))
AGG_FUSED_TIMED = ((5, 5, P_ROUND), (5, 5, P_EDGE), (100, 100, P_EDGE),
                   (1000, 1000, P_EDGE))
AGG_PLAIN_TIMED = ((3, 5, P_ROUND), (5, 5, P_ROUND), (1000, 1000, P_EDGE))
# the codec's residual K at the round's and the edge model's P (kg 3 of 8):
# 14136 and 21624, both 8 mod 16 (8-byte code stores)
K_ROUND, K_EDGE = P_ROUND // 8 * 3, P_EDGE // 8 * 3
# the quantizer's edges (C, P, chunk), each also on a misaligned base (the
# scalar variant): the codec's keyframe and residuals at the round's and
# the fleet's C, a chunk that is no power of two (40), chunks of 16 and
# 512 (a group of 1 lane, of a warp), 1024 (a warp looping over it, P
# ragged and 8 mod 16), P % 4 != 0, 4 mod 16 (4-byte stores) and a tail
# chunk; and its timed path shapes at chunk 256 (the keyframe, the round's
# and the fleet's residual)
QUANT_EDGES = ((5, P_ROUND, 256), (5, K_ROUND, 256), (1000, K_EDGE, 256),
               (2, 1000, 40), (2, 456, 16), (2, 4100, 512), (3, 4096, 1024),
               (3, 5000, 1024), (2, 1002, 64), (3, 999, 256),
               (3, 64036, 64))
QUANT_TIMED = ((5, P_ROUND, 256), (5, K_ROUND, 256), (1000, K_EDGE, 256))
# kl_similarity's edges (N, M, D) on top of the path shapes: D 37 / 128 /
# 130 (a second chunk of p), N of 1 and 129 (one past a 128-row tile), M =
# 767, each also with b on a misaligned base; the variants forced at the
# round's, C = 100 and the fleet's shapes (``kl_variants``); and the
# timed path shapes (N = C, M = 6 C)
KL_EDGES = ((1, 767, 128), (129, 767, 128), (129, 767, 37), (1, 1, 130),
            (129, 767, 130), (1, 767, 37), (64, 64, 300))
KL_VARIANT_SHAPES = ((5, 30), (100, 600), (1000, 6000))
KL_TIMED = ((5, 30), (100, 600))
# the distance kernels' edges (C, B, G, F), each under every variant its
# _plan can give and again with the query and gallery one element past a
# 16-byte boundary (the ragged variant): B of 1, 65 and 129 around the
# 64-row tiles, G of 1, 255, 257 and 1000 around the 128- and 64-row ones;
# fp32 F 64, 40 and 37 (no 16-byte rows), int8 F 64, 48 and 40 (no
# 16-byte code rows); and their path shapes: serving int8 and fp32, and
# the last evaluation of the round paths, (5, 576, 64) x (5, 2304, 64)
DIST_FP32_EDGES = ((1, 1, 1, 64), (2, 65, 255, 64), (2, 129, 257, 40),
                   (3, 7, 1000, 37), (1, 64, 1000, 64))
DIST_INT8_EDGES = ((1, 1, 1, 64), (2, 65, 255, 64), (2, 129, 257, 48),
                   (3, 7, 1000, 40), (1, 129, 1000, 64))
DIST_PATHS = {"serve_int8": (C, BATCH, G_INT8, F),
              "serve_fp32": (C, BATCH, G_FP32, F),
              "round_eval": (N_CLIENTS, 576, 2304, F)}
ROUND_OUT = ROOT / "build" / "round_fedstil.json"
CODEC = "delta+topk"                    # the wire codec of round_fedstil_codec
CODEC_OUT = ROOT / "build" / "round_fedstil_codec.json"
GROUP, KG = 8, 3                        # the codec's default grouped budget
HOST_OUT = ROOT / "build" / "round_fedstil_host.json"
CODEC_INT8 = "topk+int8"                # the codec of round_fedstil_codec_int8
INT8_OUT = ROOT / "build" / "round_fedstil_codec_int8.json"
# the wire bytes topk+int8 moves over the 60-round C=5 protocol, from the
# shapes alone (P = 37696, kg 3 of 8, chunk 256, task feature 512 bytes):
# keyframes 38800 C2S / 38289 S2C a client, then 20173 / 19662
INT8_WIRE_BYTES = 12_136_770
# a client's topk+int8 residual at P = 57664: 21624 codes, 85 scales, 3
# bit-planes of 2703 bytes
INT8_SCALE_WIRE = 30_073
VARIANT_ROUNDS = 4                      # round_host_variants' runs
# the card-vs-CPU comparison of round_fedstil_codec_int8 runs both at this
# depth (its 60-round card run is held to the byte prediction): the CPU
# rerun of the whole protocol took 20.5 s on the card's host, the largest
# share of the script's time; 30 rounds took 11.6-14.0 s, 24 paid for the
# int8 decode's phase-3 checks (~3 s), 12 (two a task) for the
# telemetry phase, 6 (one a task) for lm_decode and lm_families, and 4
# (tasks 1-4) for lm_scaleout
INT8_CPU_ROUNDS = 4
# round_zoo: the Table II baselines at benchmarks/common.py's epochs, one
# round a task (the protocol's 60 rounds cut to 6), evaluated every 2; the
# card-vs-CPU comparison runs both at ZOO_CPU_ROUNDS (tasks 1-2, one eval
# round: the 6-round CPU reruns took 21 s on the card's host, cut for
# lm_roofline)
ZOO_ROUNDS, ZOO_EPOCHS, ZOO_EVAL_EVERY = 6, 4, 2
ZOO_CPU_ROUNDS = 2
# every eval round's mAP / R1: card vs CPU (the same code on the same
# weights; at most 5.7e-7 measured on the H100) and FedProx host vs stacked
# on the card (at most 1.5e-6)
ZOO_TOL = 1e-4
ZOO_OUT = ROOT / "build" / "round_zoo.json"
# telemetry: the stacked round untraced and traced over this many rounds;
# the server round's tracing tax as benchmarks/server_round.py measures it
# (C, rounds a timing, timings a side; gated there at 2%, reported here);
# null hooks timed over this many calls each
TELEMETRY_ROUNDS = 6
TAX_CLIENTS, TAX_ITERS, TAX_REPEATS = 100, 8, 3
OVERHEAD_GATE = 0.02
NULL_HOOK_CALLS = 100_000
TRACE_OUT = ROOT / "build" / "telemetry_trace.json"
# round_sharded: the sharded engine on a world of one (NCCL) against the
# stacked card runs of round_fedstil and round_fedstil_codec_int8: every
# eval round with the float32 wire (only Eq. 6's kernel and sum order
# differ), the traced check's rounds
SHARDED_TOL = 1e-4
SHARDED_TRACE_ROUNDS = 2
SHARDED_KERNELS = ("kl_similarity", "normalize_relevance",
                   "relevance_aggregate", "batched_pairwise_dist",
                   "adaptive_combine")
SHARDED_OUT = ROOT / "build" / "round_sharded.json"

SLEEP_CYCLES = 5_000_000   # device-side sleep ahead of each timed launch
REPS, WARMUP = 30, 3

# data-sheet peaks of the card: (name substring, HBM bytes/s, fp32 FLOP/s
# outside the tensor cores, dense bf16 tensor-core FLOP/s); the first match
# wins, the H100 SXM by default
PEAKS = (("H100 PCIe", 2.0e12, 51e12, 756e12),
         ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H200", 4.8e12, 67e12, 989e12), ("H100", 3.35e12, 67e12, 989e12))

KERNELS = {
    "batched_quantize": {
        "fn": batched_quantize,
        "paths": ("serve", "serve_ivf", "round_fedstil_codec_int8",
                  "round_sharded"),
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:58"},
    # the int8 path's two dense keyframes; its residuals dequantize in
    # batched_topk_decode_int8's prologue
    "batched_dequantize": {
        "fn": batched_dequantize,
        "paths": ("round_fedstil_codec_int8", "round_sharded"),
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:94"},
    "batched_int8_pairwise_dist": {
        "fn": batched_int8_pairwise_dist, "paths": ("serve",),
        "source": "src/repro_torch/kernels/csrc/int8_dist.cu",
        "replaces": "src/repro/kernels/int8_dist.py:63"},
    "batched_pairwise_dist": {
        "fn": batched_pairwise_dist,
        "paths": ("serve", "round_fedstil", "round_fedstil_codec",
                  "round_fedstil_host", "round_fedstil_codec_int8",
                  "round_zoo", "round_sharded"),
        "source": "src/repro_torch/kernels/csrc/pairwise_dist.cu",
        "replaces": "src/repro/kernels/pairwise_dist.py:91"},
    # no main path of either package calls the 2-D form: the per-query
    # baseline takes its plain version, as the reference's does
    "pairwise_dist": {
        "fn": pairwise_dist, "paths": (),
        "source": "src/repro_torch/kernels/csrc/pairwise_dist.cu",
        "replaces": "src/repro/kernels/pairwise_dist.py:46"},
    "kl_similarity": {
        "fn": kl_similarity,
        "paths": ("round_fedstil", "round_fedstil_codec",
                  "round_fedstil_host", "round_fedstil_codec_int8",
                  "round_sharded"),
        "source": "src/repro_torch/kernels/csrc/kl_similarity.cu",
        "replaces": "src/repro/kernels/kl_similarity.py:53"},
    "fused_relevance_aggregate": {
        "fn": fused_relevance_aggregate,
        "paths": ("round_fedstil", "round_fedstil_codec",
                  "round_fedstil_codec_int8"),
        "source": "src/repro_torch/kernels/csrc/relevance_aggregate.cu",
        "replaces": "src/repro/kernels/relevance_aggregate.py:96"},
    "relevance_aggregate": {
        "fn": relevance_aggregate,
        "paths": ("round_fedstil_host", "round_sharded"),
        "source": "src/repro_torch/kernels/csrc/relevance_aggregate.cu",
        "replaces": "src/repro/kernels/relevance_aggregate.py:43"},
    # the fused kernel's first stage alone (W -> Wn): the sharded server
    # round normalizes the replicated W once, then each rank runs the
    # plain entry on its block of Wn's columns
    "normalize_relevance": {
        "fn": normalize_relevance, "paths": ("round_sharded",),
        "source": "src/repro_torch/kernels/csrc/relevance_aggregate.cu",
        "replaces": "src/repro/kernels/relevance_aggregate.py:96"},
    # every combine is one launch per dtype group over all its leaves
    # (``ops.adaptive_combine_tree``; the reference's leaf-wise tree,
    # adaptive_combine.py:47, calls the kernel below once a leaf)
    "adaptive_combine": {
        "fn": adaptive_combine_tree,
        "paths": ("round_fedstil", "round_fedstil_codec",
                  "round_fedstil_host", "round_fedstil_codec_int8",
                  "round_sharded", "lm_train", "lm_roofline",
                  "lm_scaleout", "lm_families"),
        "source": "src/repro_torch/kernels/csrc/adaptive_combine.cu",
        "replaces": "src/repro/kernels/adaptive_combine.py:36"},
    "batched_cluster_dist": {
        "fn": batched_cluster_dist, "paths": ("serve_ivf",),
        "source": "src/repro_torch/kernels/csrc/cluster_dist.cu",
        "replaces": "src/repro/kernels/ivf.py:70"},
    "batched_ivf_shortlist_scores": {
        "fn": batched_ivf_shortlist_scores, "paths": ("serve_ivf",),
        "source": "src/repro_torch/kernels/csrc/ivf_shortlist.cu",
        "replaces": "src/repro/kernels/ivf.py:126"},
    # the codec's path runs two launches a sparse payload: encode (pack +
    # bit-pack, topk_pack.py:78 and :128) and decode (bit-unpack + unpack,
    # :161 and :207; under topk+int8 the int8 decode, dequantize +
    # bit-unpack + unpack); the four one-stage kernels stay as the
    # counterparts of the reference's four functions, with no main-path
    # caller
    "batched_topk_encode": {
        "fn": batched_topk_encode,
        "paths": ("round_fedstil_codec", "round_fedstil_codec_int8",
                  "round_sharded"),
        "source": "src/repro_torch/kernels/csrc/topk_pack.cu",
        "replaces": "src/repro/kernels/topk_pack.py:78",
        "also_replaces": ["src/repro/kernels/topk_pack.py:128"]},
    "batched_topk_decode": {
        "fn": batched_topk_decode, "paths": ("round_fedstil_codec",),
        "source": "src/repro_torch/kernels/csrc/topk_pack.cu",
        "replaces": "src/repro/kernels/topk_pack.py:207",
        "also_replaces": ["src/repro/kernels/topk_pack.py:161"]},
    "batched_topk_decode_int8": {
        "fn": batched_topk_decode_int8,
        "paths": ("round_fedstil_codec_int8", "round_sharded"),
        "source": "src/repro_torch/kernels/csrc/topk_pack.cu",
        "replaces": "src/repro/kernels/quantize.py:94",
        "also_replaces": ["src/repro/kernels/topk_pack.py:161",
                          "src/repro/kernels/topk_pack.py:207"]},
    "batched_topk_pack": {
        "fn": batched_topk_pack, "paths": (),
        "source": "src/repro_torch/kernels/csrc/topk_pack.cu",
        "replaces": "src/repro/kernels/topk_pack.py:78"},
    "batched_topk_unpack": {
        "fn": batched_topk_unpack, "paths": (),
        "source": "src/repro_torch/kernels/csrc/topk_pack.cu",
        "replaces": "src/repro/kernels/topk_pack.py:207"},
    "batched_idx_bitpack": {
        "fn": batched_idx_bitpack, "paths": (),
        "source": "src/repro_torch/kernels/csrc/topk_pack.cu",
        "replaces": "src/repro/kernels/topk_pack.py:128"},
    "batched_idx_bitunpack": {
        "fn": batched_idx_bitunpack, "paths": (),
        "source": "src/repro_torch/kernels/csrc/topk_pack.cu",
        "replaces": "src/repro/kernels/topk_pack.py:161"},
    # every bf16 stage runs on a tensor-core kernel (counted in
    # ``tc_launches``); fp32 keeps flash_attention.cu's FMA kernels
    # (lm_train_reduced, phase 3's fp32 edge shapes). lm_train's count is
    # the tensor-core one; lm_decode's and lm_families' count every launch
    # (their fp32 gates and reduced steps on the FMA kernels, their bf16
    # forwards and steps on the tensor cores)
    "flash_attention_fwd": {
        "fn": flash_attention_fwd,
        "paths": ("lm_train", "lm_roofline", "lm_decode", "lm_scaleout",
                  "lm_families"),
        "counter": "tc_launches",
        "source": "src/repro_torch/kernels/csrc/flash_fwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:86"},
    "flash_attention_fwd_lse": {
        "fn": flash_attention_fwd_lse,
        "paths": ("lm_train", "lm_roofline", "lm_scaleout", "lm_families"),
        "counter": "tc_launches",
        "source": "src/repro_torch/kernels/csrc/flash_fwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention_bwd.py:171"},
    "flash_attention_dq": {
        "fn": flash_attention_dq,
        "paths": ("lm_train", "lm_roofline", "lm_scaleout", "lm_families"),
        "counter": "tc_launches",
        "source": "src/repro_torch/kernels/csrc/flash_bwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention_bwd.py:209"},
    "flash_attention_dkv": {
        "fn": flash_attention_dkv,
        "paths": ("lm_train", "lm_roofline", "lm_scaleout", "lm_families"),
        "counter": "tc_launches",
        "source": "src/repro_torch/kernels/csrc/flash_bwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention_bwd.py:226"},
}
# the codec path's kernels, and the one-stage kernels they fold, which the
# path must no longer launch; topk+int8 decodes in INT8_DECODE instead
CODEC_KERNELS = ("batched_topk_encode", "batched_topk_decode")
INT8_DECODE = "batched_topk_decode_int8"
ONE_STAGE_CODEC = ("batched_topk_pack", "batched_topk_unpack",
                   "batched_idx_bitpack", "batched_idx_bitunpack")


def zero_counts() -> None:
    """Every wrapper's launch counters to 0."""
    for spec in KERNELS.values():
        spec["fn"].launches = 0
        if hasattr(spec["fn"], "tc_launches"):
            spec["fn"].tc_launches = 0


def counts() -> dict:
    """{kernel: its launches since the last ``zero_counts``}: the
    tensor-core count where the row is the tensor-core kernel."""
    return {name: getattr(spec["fn"], spec.get("counter", "launches"))
            for name, spec in KERNELS.items()}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn) -> float:
    """Median device time of one call: CUDA events around it, behind a
    device-side sleep so the host's enqueue is not in the window."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def peaks(kind: str):
    """(HBM bytes/s, fp32 FLOP/s, bf16 tensor FLOP/s) of the card."""
    for sub, bw, fl, tc in PEAKS:
        if sub in kind:
            return bw, fl, tc
    return PEAKS[-1][1:]


def tensor_peak(peak):
    """The (bytes/s, FLOP/s) pair of ``bound`` for work the bf16 tensor
    cores could do: the flash kernels' products at bf16."""
    return peak[0], peak[2]


def bound(nbytes: float, flops: float, peak):
    t_bytes = nbytes / peak[0] * 1e3
    t_ops = flops / peak[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------


def unit_rows(gen, dev, *shape):
    x = torch.randn(shape, generator=gen, device=dev)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def int8_gallery(g):
    Cg, G, Fg = g.shape
    q8, s = REF.batched_quantize_ref(g.reshape(Cg, G * Fg), chunk=Fg)
    gq = q8.reshape(Cg, G, Fg)
    return gq, s, torch.sum(torch.square(gq.float()), -1) * torch.square(s)


def quantize_err(x, chunk):
    qk, sk = batched_quantize(x, chunk=chunk)
    qr, sr = REF.batched_quantize_ref(x, chunk=chunk)
    torch.cuda.synchronize()
    bad_q = int((qk != qr).sum())
    bad_s = int((sk.view(torch.int32) != sr.view(torch.int32)).sum())
    check(bad_q == 0 and bad_s == 0,
          f"batched_quantize {tuple(x.shape)} chunk={chunk}: {bad_q} codes "
          f"and {bad_s} scales differ from the plain version")
    return max(float((qk.int() - qr.int()).abs().max()),
               float((sk - sr).abs().max()))


def dist_err(name, kernel, plain, *args):
    out_k = kernel(*args)
    out_r = plain(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_k).all()), f"{name}: non-finite output")
    err = float((out_k - out_r).abs().max())
    check(err <= DIST_TOL, f"{name} {tuple(out_k.shape)}: max_abs_err {err} "
          f"> {DIST_TOL}")
    return err


def dist_work(name, c, b, g, f):
    """(bytes, FLOPs) of a distance call, (c, b, f) queries against (c, g,
    f) gallery rows: each operand read once (int8 codes with their scales
    and norms, the cluster kernel's given norms), the (c, b, g) output
    written once, 2 c b g f FLOPs."""
    if name == "batched_int8_pairwise_dist":
        nbytes = 4.0 * c * b * f + c * g * f + 8.0 * c * g + 4.0 * c * b * g
    else:
        nbytes = 4.0 * (c * b * f + c * g * f + c * b * g
                        + (c * g if name == "batched_cluster_dist" else 0))
    return nbytes, 2.0 * c * b * g * f


DIST_PLAIN = {
    "batched_pairwise_dist": REF.batched_pairwise_dist_ref,
    "pairwise_dist": REF.pairwise_dist_ref,
    "batched_int8_pairwise_dist": REF.batched_int8_pairwise_dist_ref,
    "batched_cluster_dist": REF.batched_cluster_dist_ref}
DIST_MODE = {"batched_pairwise_dist": "fp32", "pairwise_dist": "fp32",
             "batched_int8_pairwise_dist": "int8",
             "batched_cluster_dist": "norms"}


def dist_operands(name, gen, dev, c, b, g, f):
    """Unit-row operands of a distance entry at (c, b, g, f): the 2-D entry
    takes client 0's rows."""
    q, gal = unit_rows(gen, dev, c, b, f), unit_rows(gen, dev, c, g, f)
    if name == "batched_int8_pairwise_dist":
        return (q, *int8_gallery(gal))
    if name == "batched_cluster_dist":
        return q, gal, torch.sum(gal * gal, -1)
    if name == "pairwise_dist":
        return q[0], gal[0]
    return q, gal


def dist_forced(name, variant):
    """The distance entry ``name`` under ``variant`` wherever its _plan
    can give it (the tile needs 16-byte rows and bases; the plan of an
    unaligned base is ragged), else under the plan's own: returns (out,
    the variant run). Launches outside the wrappers: not counted."""
    launch = {"batched_pairwise_dist": PD._batched,
              "pairwise_dist": PD._pairwise,
              "batched_int8_pairwise_dist": I8M._launch,
              "batched_cluster_dist": IVFM._cluster}[name]

    def run(q, g, *rest):
        c, b, f = (1, *q.shape) if q.dim() == 2 else q.shape
        plan = PD._plan(c, b, g.shape[-2], f, DIST_MODE[name],
                        variant == "tile" and PD._aligned(q, g))
        return launch(q, g, *rest, plan), plan.variant
    return run


def dist_variant_errs(name, *args):
    """``name`` under each variant against its plain version (<= DIST_TOL),
    the variants' outputs equal bit for bit: (max error, variants run)."""
    want = DIST_PLAIN[name](*args)
    runs = [dist_forced(name, v)(*args) for v in PD.VARIANTS]
    torch.cuda.synchronize()
    shape = tuple(runs[0][0].shape)
    err = 0.0
    for out, used in runs:
        check(bool(torch.isfinite(out).all()),
              f"{name} {shape} ({used}): non-finite output")
        e = float((out - want).abs().max())
        check(e <= DIST_TOL, f"{name} {shape} ({used}): max_abs_err {e} > "
              f"{DIST_TOL}")
        err = max(err, e)
    check(all(torch.equal(runs[0][0].view(torch.int32), o.view(torch.int32))
              for o, _ in runs),
          f"{name} {shape}: the variants' outputs differ")
    return err, sorted({used for _, used in runs})


def dist_edges(gen, dev, name, edges):
    """``name`` at ``edges`` under every variant, aligned and on bases off
    16 bytes: (max error, [[C, B, G, F, aligned, variants run], ..])."""
    err, out = 0.0, []
    for c, b, g, f in edges:
        args = dist_operands(name, gen, dev, c, b, g, f)
        for al in (True, False):
            xs = args if al else (offset_copy(args[0]), offset_copy(args[1]),
                                  *args[2:])
            e, ran = dist_variant_errs(name, *xs)
            err = max(err, e)
            out.append([c, b, g, f, al, ran])
    return err, out


def dist_timings(gen, dev, peak, name, paths):
    """``name`` at the path shapes ``paths`` (keys of DIST_PATHS), checked
    under every variant, timed through its wrapper (the planned variant)
    and under each variant forced, beside its plain version, its bound and,
    for the fp32 entries, one baddbmm with the norms."""
    out = []
    for path in paths:
        c, b, g, f = DIST_PATHS[path]
        args = dist_operands(name, gen, dev, c, b, g, f)
        err, _ = dist_variant_errs(name, *args)
        bd = bound(*dist_work(name, c, b, g, f), peak)
        fn = KERNELS[name]["fn"]
        ms = time_ms(lambda: fn(*args))
        row = {"path": path, "shape": [c, b, g, f], "max_abs_err": err,
               "variant": plan_of(PD, c, b, g, f, DIST_MODE[name],
                                  aligned(args[0]) and aligned(args[1])),
               "ms": ms, "bound_ms": bd[0], "bound_by": bd[1],
               "bound_share": bd[0] / ms,
               "plain_ms": time_ms(lambda: DIST_PLAIN[name](*args))}
        for v in PD.VARIANTS:
            run = dist_forced(name, v)
            row[f"{v}_ms"] = time_ms(lambda: run(*args))
        if name != "batched_int8_pairwise_dist":
            row["library_ms"] = time_ms(lambda: dist_library(name, *args))
        out.append(row)
    return out


def dist_library(name, q, g, *rest):
    """One PyTorch call for the fp32 distances, norms included (baddbmm,
    addmm for the 2-D entry; the cluster kernel's norms given)."""
    if name == "pairwise_dist":
        qq = torch.sum(q * q, -1)[:, None]
        return torch.addmm(qq + torch.sum(g * g, -1)[None, :], q, g.T,
                           alpha=-2)
    qq = torch.sum(q * q, -1)[:, :, None]
    gg = rest[0] if rest else torch.sum(g * g, -1)
    return torch.baddbmm(qq + gg[:, None, :], q, g.transpose(1, 2), alpha=-2)


def dist_sass(source):
    """csrc/<source>.cu's SASS: FFMA, no tensor-core instruction (HMMA or
    HGMMA), no spills (``kernel_sass``)."""
    sass = kernel_sass(source)
    check(sass["hgmma"] == 0 and sass["hmma"] == 0,
          f"{source}: tensor-core instructions in {sass}")
    return sass


def dist_kernel_rows(gen, dev, peak):
    """The two serving distance kernels (rows 3 and 4 of PERF.md) at their
    edges under every variant, and at their path shapes, timed there; the
    row's own time at the serving shape."""
    rows = {}
    for name, edges, paths, source in (
            ("batched_int8_pairwise_dist", DIST_INT8_EDGES, ("serve_int8",),
             "int8_dist"),
            ("batched_pairwise_dist", DIST_FP32_EDGES,
             ("serve_fp32", "round_eval"), "pairwise_dist")):
        err, edge_rows = dist_edges(gen, dev, name, edges)
        by_shape = dist_timings(gen, dev, peak, name, paths)
        head = by_shape[0]
        rows[name] = dict(
            max_abs_err=max(err, *(r["max_abs_err"] for r in by_shape)),
            bound=(head["bound_ms"], head["bound_by"]), ms=head["ms"],
            plain_ms=head["plain_ms"], library_ms=head.get("library_ms"),
            shape=head["shape"],
            detail={"variant": head["variant"], "edges": edge_rows,
                    "by_shape": by_shape, "sass": dist_sass(source),
                    "library": ("none: no one PyTorch call takes int8 codes "
                                "with row scales") if "int8" in name else
                    "torch.baddbmm with the norms"})
    return rows


def phase_kernels(dev, peak, card):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}

    # batched_quantize: the refresh's shape (one scale per feature row), a
    # row with a tail chunk, an all-zero chunk and exact half-way values,
    # and a wide chunk
    x = unit_rows(gen, dev, C, G_INT8, F).reshape(C, G_INT8 * F)
    err = quantize_err(x, F)
    xr = torch.randn((3, 1000 * F + 37), generator=gen, device=dev)
    xr[0, :F] = 0.0
    halves = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                          device=dev)
    xr[1, :F] = 0.0
    xr[1, :halves.numel()] = halves
    err = max(err, quantize_err(xr, F),
              quantize_err(torch.randn((2, 999), generator=gen, device=dev),
                           256))
    edges = []
    for c, p, chunk in QUANT_EDGES:
        xe = 3.0 * torch.randn((c, p), generator=gen, device=dev)
        xe[0, :chunk] = 0.0                       # an all-zero chunk
        xe[-1, :halves.numel()] = halves          # exact half-way codes
        for xx in (xe, offset_copy(xe)):
            err = max(err, quantize_err(xx, chunk))
            edges.append([c, p, chunk, plan_of(QZ, c, p, chunk,
                                               aligned(xx))])
    P = G_INT8 * F
    for c, p, chunk in ((C, P, F), (5, K_ROUND, 256), (1000, K_EDGE, 256)):
        check(QZ._plan(c, p, chunk, True).variant == "vector",
              f"batched_quantize ({c}, {p}) chunk {chunk}: not vector")
    rows["batched_quantize"] = dict(
        max_abs_err=err, bound=bound(*quantize_work(C, P, F), peak),
        ms=time_ms(lambda: batched_quantize(x, chunk=F)),
        plain_ms=time_ms(lambda: REF.batched_quantize_ref(x, chunk=F)),
        library_ms=None, shape=[C, P],
        detail={"variant": plan_of(QZ, C, P, F, aligned(x)),
                "store_bytes": QZ._plan(C, P, F, aligned(x)).store,
                "edges": edges, "by_shape": quantize_timings(gen, dev, peak),
                "sass": kernel_sass("quantize", ffma=False)})

    rows.update(dist_kernel_rows(gen, dev, peak))
    rows.update(relevance_kernel_rows(gen, dev, peak))
    rows.update(ivf_kernel_rows(gen, dev, peak))
    rows.update(topk_kernel_rows(gen, dev, peak))
    rows.update(decode_int8_rows(gen, dev, peak))
    rows.update(new_kernel_rows(gen, dev, peak))
    rows.update(combine_tree_rows(gen, dev, peak))
    rows.update(flash_kernel_rows(gen, dev, peak))

    for name, r in rows.items():
        emit({"phase": "kernel_check", "card": card, "name": name,
              "shape": r["shape"], "max_abs_err": r["max_abs_err"],
              "ms": r["ms"], "plain_ms": r["plain_ms"],
              "library_ms": r["library_ms"], "bound_ms": r["bound"][0],
              "bound_by": r["bound"][1], **r.get("detail", {})})
    return rows


def plan_of(module, *args):
    """The variant ``module._plan`` picks for ``args`` ("one" for a tree
    whose kernel has no plan)."""
    plan = getattr(module, "_plan", None)
    return plan(*args).variant if plan else "one"


def aligned(t):
    return t.data_ptr() % 16 == 0


def quantize_work(c, p, chunk):
    """(bytes, operations) of quantizing (c, p): each value read once, each
    code and scale written once; a compare, a division and a round a
    value."""
    return 5.0 * c * p + 4.0 * c * -(-p // chunk), 3.0 * c * p


def quantize_timings(gen, dev, peak):
    """The quantizer at ``QUANT_TIMED`` (the codec's path shapes, chunk
    256) beside its plain version, each with its variant, bound and share."""
    out = []
    for c, p, chunk in QUANT_TIMED:
        x = torch.randn((c, p), generator=gen, device=dev)
        b = bound(*quantize_work(c, p, chunk), peak)
        ms = time_ms(lambda: batched_quantize(x, chunk=chunk))
        out.append({"shape": [c, p, chunk],
                    "variant": plan_of(QZ, c, p, chunk, aligned(x)), "ms": ms,
                    "plain_ms": time_ms(lambda: REF.batched_quantize_ref(
                        x, chunk=chunk)),
                    "bound_ms": b[0], "bound_by": b[1],
                    "bound_share": b[0] / ms})
    return out


def kernel_sass(source, ffma=True):
    """csrc/<source>.cu's SASS report: no kernel of it spills (local memory
    or stack), and, for the FMA tiles (aggregate, KL), FFMA present."""
    sass = sass_report(source)
    spills = {k: u for k, u in sass["by_kernel"].items()
              if u["local_bytes"] or u["stack_bytes"]}
    check(bool(sass["by_kernel"]) and not spills,
          f"{source}: kernels with spills {spills}")
    check(sass["ffma"] > 0 or not ffma, f"{source}: no FFMA in {sass}")
    return sass


def task_features(gen, dev, n):
    """(n, proto_dim) rows like the server's task features: means of tanh
    prototypes, entries in (-1, 1)."""
    return torch.tanh(torch.randn((n, CFG.proto_dim), generator=gen,
                                  device=dev))


def kl_err(a, b, kernel=kl_similarity):
    out_k = kernel(a, b)
    out_r = REF.kl_similarity_ref(a, b)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_k).all()), "kl_similarity: non-finite")
    err = float((out_k - out_r).abs().max())
    check(err <= KL_TOL, f"kl_similarity {tuple(a.shape)} x {tuple(b.shape)}"
          f": max_abs_err {err} > {KL_TOL}")
    return err


def kl_work(n, m, d):
    """(bytes, FLOPs) of S (n, m) from a (n, d), b (m, d): both read once, S
    written once; the product's 2 n m d (the softmaxes are O((n + m) d))."""
    return 4.0 * (n * d + m * d + n * m), 2.0 * n * m * d


def kl_forced(variant):
    """kl_similarity under a forced variant (launches outside the wrapper:
    not counted)."""
    def run(a, b):
        n, d = a.shape
        m = b.shape[0]
        plan = KLM._plan(n, m, d, aligned(b))
        if plan.variant != variant:
            plan = KLM._plan(n, m, d, aligned(b),
                             split_min_tiles=0 if variant == "split" else
                             float("inf"))
        return KLM._launch(a, b, plan)
    return run


def kl_variants(gen, dev):
    """Both variants forced at the round's, C = 100 and the fleet's shapes
    (timed; their outputs equal bit for bit) and at the edges (within
    KL_TOL of the plain version, b aligned and not): the times that set
    ``SPLIT_MIN_TILES``."""
    D = CFG.proto_dim
    out = []
    for n, m in KL_VARIANT_SHAPES:
        a, b = task_features(gen, dev, n), task_features(gen, dev, m)
        row, outs = {"N": n, "M": m, "plan": plan_of(KLM, n, m, D, True)}, []
        for variant in KLM.VARIANTS:
            run = kl_forced(variant)
            kl_err(a, b, run)
            outs.append(run(a, b))
            row[f"{variant}_ms"] = time_ms(lambda: run(a, b))
        torch.cuda.synchronize()
        check(all(torch.equal(outs[0], o) for o in outs),
              f"kl_similarity {n} x {m}: the variants' outputs differ")
        out.append(row)
    for n, m, d in KL_EDGES:
        a = torch.randn((n, d), generator=gen, device=dev)
        b = torch.randn((m, d), generator=gen, device=dev)
        for variant in KLM.VARIANTS:
            kl_err(a, b, kl_forced(variant))
            kl_err(a, offset_copy(b), kl_forced(variant))
    return out


def kl_timings(gen, dev, peak):
    """kl_similarity at ``KL_TIMED`` (N = C, M = 6 C, D = 128) beside its
    plain version, each with its variant, bound and share."""
    D = CFG.proto_dim
    out = []
    for n, m in KL_TIMED:
        a, b = task_features(gen, dev, n), task_features(gen, dev, m)
        bd = bound(*kl_work(n, m, D), peak)
        ms = time_ms(lambda: kl_similarity(a, b))
        out.append({"shape": [n, m, D],
                    "variant": plan_of(KLM, n, m, D, aligned(b)), "ms": ms,
                    "plain_ms": time_ms(lambda: REF.kl_similarity_ref(a, b)),
                    "bound_ms": bd[0], "bound_by": bd[1],
                    "bound_share": bd[0] / ms})
    return out


def kl_kernels_a_call(gen, dev):
    """The device kernels of one kl_similarity call at the round's shape
    (N = 5, M = 30), from torch.profiler: one."""
    a = task_features(gen, dev, N_CLIENTS)
    b = task_features(gen, dev, N_CLIENTS * HIST_K)
    kl_similarity(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kl_similarity(a, b)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(len(names) == 1, f"kl_similarity at C = 5 ran kernels {names}")
    return names


def aggregate_err(w, th):
    b_k, wn_k = fused_relevance_aggregate(w, th)
    b_r, wn_r = REF.fused_relevance_aggregate_ref(w, th)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(b_k).all() and torch.isfinite(wn_k).all()),
          "fused_relevance_aggregate: non-finite output")
    e_wn = float((wn_k - wn_r).abs().max())
    e_b = float((b_k - b_r).abs().max())
    check(e_wn <= WN_TOL and e_b <= AGG_TOL,
          f"fused_relevance_aggregate C={w.shape[0]} P={th.shape[1]}: Wn err "
          f"{e_wn} (<= {WN_TOL}), B err {e_b} (<= {AGG_TOL})")
    return max(e_wn, e_b)


def relevance_kernel_rows(gen, dev, peak):
    """The round's two server kernels at C = 5, 100 and ragged shapes for
    correctness, timed at the C = 1000 server shapes."""
    rows = {}
    D, k = CFG.proto_dim, HIST_K
    err = 0.0
    for n, m, d in ((5, 5 * k, D), (100, 100 * k, D), (7, 7 * k - 1, D),
                    (3, 5, 37)):
        err = max(err, kl_err(task_features(gen, dev, n)[:, :d].contiguous(),
                              task_features(gen, dev, m)[:, :d].contiguous()),
                  kl_err(torch.randn((n, d), generator=gen, device=dev),
                         torch.randn((m, d), generator=gen, device=dev)))
    for n, m, d in KL_EDGES:
        a = torch.randn((n, d), generator=gen, device=dev)
        b = torch.randn((m, d), generator=gen, device=dev)
        err = max(err, kl_err(a, b), kl_err(a, offset_copy(b)),
                  kl_err(offset_copy(a), b))
    C = SCALE_CLIENTS[-1]
    N, M = C, C * k
    a, b = task_features(gen, dev, N), task_features(gen, dev, M)
    err = max(err, kl_err(a, b))
    rows["kl_similarity"] = dict(
        max_abs_err=err, bound=bound(*kl_work(N, M, D), peak),
        ms=time_ms(lambda: kl_similarity(a, b)),
        plain_ms=time_ms(lambda: REF.kl_similarity_ref(a, b)),
        library_ms=None, shape=[N, M, D],
        detail={"variant": plan_of(KLM, N, M, D, aligned(b)),
                "by_shape": kl_timings(gen, dev, peak),
                "variants": kl_variants(gen, dev),
                "kernels_a_call_at_c5": kl_kernels_a_call(gen, dev),
                "sass": kernel_sass("kl_similarity")})

    def relevance(c):
        return torch.rand((c, c), generator=gen, device=dev)

    def params(c, p):
        return torch.randn((c, p), generator=gen, device=dev)

    err = 0.0
    for c, p in AGG_FUSED_EDGES:
        w = relevance(c)
        w.fill_diagonal_(7.5)                 # finite junk on the diagonal
        w[1] = 0.0                            # an all-zero row
        th = params(c, p)
        err = max(err, aggregate_err(w, th))
        if p % 4 == 0:                        # a misaligned base: ragged
            err = max(err, aggregate_err(w, offset_copy(th)))
    for c, p in ((6, 1000), (6, 1001), (SCALE_CLIENTS[-1], 1000),
                 (SCALE_CLIENTS[-1], 1001)):
        th = params(c, p)
        zb, zw = fused_relevance_aggregate(torch.zeros((c, c), device=dev),
                                           th)
        torch.cuda.synchronize()
        check(not bool(zb.any()) and not bool(zw.any()),
              f"fused_relevance_aggregate C={c}: all-zero W gave nonzero "
              "output")
        w = relevance(c)
        w.fill_diagonal_(float("nan"))        # NaN on the diagonal
        err = max(err, aggregate_err(w, th))
    w, th = relevance(C), params(C, P_EDGE)
    err = max(err, aggregate_err(w, th))
    wn = REF.normalized_relevance_ref(w)
    rows["fused_relevance_aggregate"] = dict(
        max_abs_err=err,
        bound=bound(*aggregate_work(C, C, P_EDGE, True), peak),
        ms=time_ms(lambda: fused_relevance_aggregate(w, th)),
        plain_ms=time_ms(lambda: REF.fused_relevance_aggregate_ref(w, th)),
        library_ms=time_ms(lambda: torch.mm(wn, th)),
        shape=[C, P_EDGE],
        detail={"library": "torch.mm(Wn, Theta), TF32 off",
                "by_shape": aggregate_timings(gen, dev, peak, True),
                "skinny_vs_tiled": skinny_vs_tiled(gen, dev),
                "sass": kernel_sass("relevance_aggregate")})

    # normalize_relevance: the sharded path's C = 5, both sides of the
    # skinny variant's largest C (the fused Wn it must equal bit for bit
    # comes from the skinny or the tiled variant), the fleet's C; finite
    # junk or NaN on the diagonal, an all-zero row, a NaN off the diagonal
    err = 0.0
    for c in (1, 5, 6, 32, 33, 100, 257, C, C + 1):
        w = relevance(c)
        w.fill_diagonal_(7.5 if c % 2 else float("nan"))
        if c > 2:
            w[1] = 0.0
            w[2, 0] = float("nan")
        err = max(err, normalize_err(w))
    w = relevance(C)
    rows["normalize_relevance"] = dict(
        max_abs_err=max(err, normalize_err(w)),
        bound=bound(*normalize_work(C), peak),
        ms=time_ms(lambda: normalize_relevance(w)),
        plain_ms=time_ms(lambda: REF.normalized_relevance_ref(w)),
        library_ms=None, shape=[C, C],
        detail={"library": "none: no one PyTorch call masks the diagonal "
                "and normalizes the rows",
                "by_C": {c: time_ms(functools.partial(normalize_relevance,
                                                      relevance(c)))
                         for c in (N_CLIENTS, 100)}})
    return rows


def normalize_err(w):
    """normalize_relevance against its plain version (within WN_TOL) and
    against the fused entry's Wn (bit for bit: the same normalize_kernel,
    or at C <= 32 the skinny variant's one-warp sum in the same order)."""
    C = w.shape[0]
    wn_k = normalize_relevance(w)
    wn_r = REF.normalized_relevance_ref(w)
    _, wn_f = fused_relevance_aggregate(
        w, torch.zeros((C, 4), dtype=torch.float32, device=w.device))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(wn_k).all()), "normalize_relevance: non-finite")
    check(torch.equal(wn_k, wn_f), f"normalize_relevance C={C}: Wn differs "
          "from the fused entry's")
    err = float((wn_k - wn_r).abs().max())
    check(err <= WN_TOL, f"normalize_relevance C={C}: max_abs_err {err} > "
          f"{WN_TOL}")
    return err


def normalize_work(c):
    """(bytes, FLOPs) of Wn from W (c, c): W read once, Wn written once; an
    add into the row sum and a divide an entry."""
    return 8.0 * c * c, 2.0 * c * c


def skinny_vs_tiled(gen, dev):
    """Both entries (R = C) forced onto the skinny and onto the tiled
    variant at C up to the skinny one's largest, P = 57664: the times that
    set ``SKINNY_MAX_C`` (launches outside the wrappers: not counted)."""
    out = []
    for c in (5, 8, 16, 24, 32):
        w = torch.rand((c, c), generator=gen, device=dev)
        wn = REF.normalized_relevance_ref(w)
        th = torch.randn((c, P_EDGE), generator=gen, device=dev)
        row = {"C": c}
        for variant, most in (("skinny", RA.SKINNY_MAX_C), ("tiled", 0)):
            plan = RA._plan(c, c, P_EDGE, True, skinny_max_c=most)
            check(plan.variant == variant, f"{plan} is not {variant}")
            row[f"fused_{variant}_ms"] = time_ms(lambda: RA._fused(w, th,
                                                                   plan))
            row[f"plain_{variant}_ms"] = time_ms(lambda: RA._plain(wn, th,
                                                                   plan))
        out.append(row)
    return out


def aggregate_work(r, c, p, fused):
    """(bytes, FLOPs) of B = W Theta, W (r, c), Theta (c, p): W and Theta
    read once, B written once, and the fused entry's Wn (c, c) written."""
    nbytes = 4.0 * (r * c + c * p + r * p) + (4.0 * c * c if fused else 0.0)
    return nbytes, 2.0 * r * c * p


def aggregate_timings(gen, dev, peak, fused):
    """Both aggregate entries timed at ``AGG_FUSED_TIMED`` /
    ``AGG_PLAIN_TIMED`` beside their plain versions and ``torch.mm`` of the
    normalized rows (TF32 off), each with its bound and its share of it."""
    out = []
    for r, c, p in AGG_FUSED_TIMED if fused else AGG_PLAIN_TIMED:
        th = torch.randn((c, p), generator=gen, device=dev)
        w = torch.rand((r, c), generator=gen, device=dev)
        if fused:
            wn = REF.normalized_relevance_ref(w)
            kern = lambda: fused_relevance_aggregate(w, th)  # noqa: E731
            plain = lambda: REF.fused_relevance_aggregate_ref(w, th)  # noqa: E731,E501
        else:
            w = wn = w / w.sum(1, keepdim=True)
            kern = lambda: relevance_aggregate(w, th)  # noqa: E731
            plain = lambda: REF.relevance_aggregate_ref(w, th)  # noqa: E731
        b = bound(*aggregate_work(r, c, p, fused), peak)
        ms = time_ms(kern)
        out.append({"shape": [r, c, p],
                    "variant": RA._plan(r, c, p, True).variant, "ms": ms,
                    "plain_ms": time_ms(plain),
                    "library_ms": time_ms(lambda: torch.mm(wn, th)),
                    "bound_ms": b[0], "bound_by": b[1],
                    "bound_share": b[0] / ms})
    return out


def shortlist_err(qf, probe, bq, pack):
    dk, ik = batched_ivf_shortlist_scores(qf, probe, bq, pack)
    dr, ir = REF.batched_ivf_shortlist_scores_ref(qf, probe, bq, pack)
    torch.cuda.synchronize()
    shape = tuple(dk.shape)
    check(bool(torch.isfinite(dk).all()), f"shortlist {shape}: non-finite")
    check(torch.equal(ik, ir), f"shortlist {shape}: row ids differ from the "
          "plain version")
    err = float((dk - dr).abs().max())
    check(err <= DIST_TOL, f"shortlist {shape}: max_abs_err {err} > "
          f"{DIST_TOL}")
    return err


def bucket_image(gen, dev, c, l, k, f, empty_frac, ragged=False):
    """A bucket-major int8 image ((c, l, k, f) codes, (c, l, 3, k) sidecar)
    of quantized unit rows, as the index holds, ``empty_frac`` of the
    slots empty (codes 0, scale 1, norm 0, id -1); ``ragged`` empties
    bucket 4 of client 1 and the whole last client."""
    codes, scale, n2 = int8_gallery(unit_rows(gen, dev, c, l * k, f))
    bids = torch.randint(0, 1 << 30, (c, l, k), generator=gen, device=dev,
                         dtype=torch.int32)
    u = torch.rand((c, l, k), generator=gen, device=dev)
    if ragged:
        u[1, 4] = -1.0
        u[-1] = -1.0
    present = u >= empty_frac
    bids = torch.where(present, bids, -1)
    codes = torch.where(present[..., None], codes.reshape(c, l, k, f), 0)
    scale = torch.where(present, scale.reshape(c, l, k), 1.0)
    n2 = torch.where(present, n2.reshape(c, l, k), 0.0)
    pack = torch.stack([scale.view(torch.int32), n2.view(torch.int32), bids],
                       dim=2).view(torch.float32)
    return codes.to(torch.int8).contiguous(), pack


def ivf_kernel_rows(gen, dev, peak):
    """The IVF path's two kernels at its shapes (C=4, B=64, L=512, bcap=384,
    nprobe 8, F=64) and at ragged ones: B and L off every tile, an empty
    bucket, an all-invalid client, a feature width not a multiple of 16."""
    rows = {}
    L, Kc = 512, 384
    name = "batched_cluster_dist"
    err = 0.0
    for (c, b, l, f) in ((3, 7, 130, 64), (2, 70, 100, 40), (1, 1, 3, 64),
                         (2, 65, 257, 64)):
        cent = unit_rows(gen, dev, c, l, f)
        cent[-1] = 0.0                       # a client with no centroids
        qe, cn = unit_rows(gen, dev, c, b, f), torch.sum(cent * cent, -1)
        err = max(err, dist_err(name, batched_cluster_dist,
                                REF.batched_cluster_dist_ref, qe, cent, cn),
                  dist_variant_errs(name, qe, cent, cn)[0],
                  dist_variant_errs(name, offset_copy(qe),
                                    offset_copy(cent), cn)[0])
    q = unit_rows(gen, dev, C, BATCH, F)
    cent = 0.9 * unit_rows(gen, dev, C, L, F)
    cn2 = torch.sum(cent * cent, -1)
    err = max(err, dist_err(name, batched_cluster_dist,
                            REF.batched_cluster_dist_ref, q, cent, cn2),
              dist_variant_errs(name, q, cent, cn2)[0])
    rows[name] = dict(
        max_abs_err=err,
        bound=bound(*dist_work(name, C, BATCH, L, F), peak),
        ms=time_ms(lambda: batched_cluster_dist(q, cent, cn2)),
        plain_ms=time_ms(lambda: REF.batched_cluster_dist_ref(q, cent, cn2)),
        library_ms=time_ms(lambda: dist_library(name, q, cent, cn2)),
        shape=[C, BATCH, L, F],
        detail={"variant": plan_of(PD, C, BATCH, L, F, "norms", True),
                **{f"{v}_ms": time_ms(lambda: dist_forced(name, v)(
                    q, cent, cn2)) for v in PD.VARIANTS},
                "sass": dist_sass("cluster_dist")})

    name = "batched_ivf_shortlist_scores"
    err = 0.0
    for (c, b, p, l, k, f) in ((3, 7, 5, 6, 37, 64), (2, 5, 3, 9, 50, 40)):
        bq, pack = bucket_image(gen, dev, c, l, k, f, 0.3, ragged=True)
        probe = torch.randint(0, l, (c, b, p), generator=gen, device=dev,
                              dtype=torch.int32)
        probe[1, 0, 0] = 4
        err = max(err, shortlist_err(unit_rows(gen, dev, c, b, f), probe, bq,
                                     pack))
    bq, pack = bucket_image(gen, dev, C, L, Kc, F, 1.0 / 3.0)
    probe = torch.randint(0, L, (C, BATCH, NPROBE), generator=gen, device=dev,
                          dtype=torch.int32)
    err = max(err, shortlist_err(q, probe, bq, pack))
    # the buckets these probes need, each read once, and the two outputs
    distinct = int(torch.unique(probe + L * torch.arange(
        C, device=dev)[:, None, None]).numel())
    nbytes = (distinct * (Kc * F + 3 * Kc * 4) + C * BATCH * F * 4
              + C * BATCH * NPROBE * 4 + 2 * C * BATCH * NPROBE * Kc * 4)
    rows[name] = dict(
        max_abs_err=err,
        bound=bound(nbytes, 2.0 * C * BATCH * NPROBE * Kc * F, peak),
        ms=time_ms(lambda: batched_ivf_shortlist_scores(q, probe, bq, pack)),
        plain_ms=time_ms(lambda: REF.batched_ivf_shortlist_scores_ref(
            q, probe, bq, pack)),
        library_ms=None, shape=[C, BATCH, NPROBE, L, Kc, F],
        detail={"distinct_buckets": distinct, "bound_bytes": nbytes})
    return rows


def codec_rows(gen, dev, c, p, aligned=True):
    """(c, p) payload rows as the codec sees them, with exact ties (row 0
    rounded to halves, magnitudes repeated with both signs), two all-zero
    groups, an all-zero row and a ragged tail of zeros; ``aligned=False``
    puts the rows at a base 4 bytes off 16, so the pack takes its scalar
    loads at a P where the vector loads would otherwise run."""
    x = torch.randn((c, p), generator=gen, device=dev)
    x[0] = torch.round(x[0] * 2.0) / 2.0
    x[min(1, c - 1), :2 * GROUP] = 0.0
    if c > 2:
        x[2] = 0.0
    x[-1, p - p % GROUP if p % GROUP else p - GROUP:] = 0.0
    if aligned:
        return x
    out = torch.empty((c * p + 1,), device=dev)[1:].view(c, p)
    out.copy_(x)
    return out


def exact(a, b) -> bool:
    """Equal shapes and values under == (+0.0 == -0.0), NaN exactly where
    the other has NaN: the codec's outputs against their plain versions."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.isclose(a, b, rtol=0.0, atol=0.0, equal_nan=True).all())


def exact_err(a, b) -> float:
    """The largest |a - b| where the two are not ``exact`` alike (0.0 when
    they agree everywhere)."""
    if a.numel() == 0:
        return 0.0
    same = torch.isclose(a, b, rtol=0.0, atol=0.0, equal_nan=True)
    d = (a.double() - b.double()).abs()
    return float(torch.where(same, torch.zeros_like(d), d).max())


def nonfinite_rows(gen, dev, c, p):
    """``codec_rows`` with 3% of the entries NaN, +inf or -inf: groups
    that hold one spread x * 0 = NaN across their slots (the encode's full
    one-hot path), the rest take its finite shortcut."""
    x = codec_rows(gen, dev, c, p)
    hit = torch.rand((c, p), generator=gen, device=dev) < 0.03
    pick = torch.randint(0, 3, (c, p), generator=gen, device=dev)
    bad = torch.tensor([float("nan"), float("inf"), float("-inf")],
                       device=dev)[pick]
    return torch.where(hit, bad, x)


def topk_errs(x, kg):
    """The six codec kernels on ``x`` against their plain versions: values
    equal under == with NaN where the plain version has NaN, indices and
    packed bytes bit-identical; the encode against pack then bit-pack, the
    decode against bit-unpack then unpack. Returns each kernel's largest
    absolute difference (0 when they agree)."""
    C, P = x.shape
    finite = bool(torch.isfinite(x).all())
    vk, ik = batched_topk_pack(x, group=GROUP, kg=kg)
    vr, ir = REF.batched_topk_pack_ref(x, group=GROUP, kg=kg)
    K = ik.shape[1]
    dk = batched_topk_unpack(vr, ir, p=P, group=GROUP, kg=kg)
    dr = REF.batched_topk_unpack_ref(vr, ir, p=P, group=GROUP, kg=kg)
    pk = batched_idx_bitpack(ir, group=GROUP, kg=kg)
    pr = REF.batched_idx_bitpack_ref(ir, group=GROUP, kg=kg)
    bk = batched_idx_bitunpack(pr, k=K, group=GROUP, kg=kg)
    br = REF.batched_idx_bitunpack_ref(pr, k=K, group=GROUP, kg=kg)
    ve, pe = batched_topk_encode(x, group=GROUP, kg=kg)
    de = batched_topk_decode(vr, pr, k=K, p=P, group=GROUP, kg=kg)
    der = REF.batched_topk_decode_ref(vr, pr, k=K, p=P, group=GROUP, kg=kg)
    torch.cuda.synchronize()
    shape = f"C={C} P={P} kg={kg}{'' if finite else ' non-finite'}"
    check(exact(vk, vr) and torch.equal(ik, ir),
          f"batched_topk_pack {shape}: differs from the plain version")
    check(exact(dk, dr),
          f"batched_topk_unpack {shape}: differs from the plain version")
    check(torch.equal(pk, pr),
          f"batched_idx_bitpack {shape}: differs from the plain version")
    check(torch.equal(bk, br) and (not finite or torch.equal(bk, ir)),
          f"batched_idx_bitunpack {shape}: does not give back the indices")
    check(exact(ve, vr) and torch.equal(pe, pr),
          f"batched_topk_encode {shape}: differs from pack + bit-pack")
    check(exact(de, der),
          f"batched_topk_decode {shape}: differs from bit-unpack + unpack")
    return {"batched_topk_pack": max(exact_err(vk, vr),
                                     float((ik - ir).abs().max())),
            "batched_topk_unpack": exact_err(dk, dr),
            "batched_idx_bitpack": float((pk.int() - pr.int()).abs().max()),
            "batched_idx_bitunpack": float((bk - br).abs().max()),
            "batched_topk_encode": max(exact_err(ve, vr),
                                       float((pe.int() - pr.int())
                                             .abs().max())),
            "batched_topk_decode": exact_err(de, der)}


def codec_variant_errs(x, kg, group=GROUP):
    """Encode and decode under every per-thread variant (``TP._plan``'s
    ``per`` forced; launches not counted) against their plain versions on
    ``x``: the variant the plan would not pick at this shape held too."""
    C, P = x.shape
    vr, pr = REF.batched_topk_encode_ref(x, group=group, kg=kg)
    dr = REF.batched_topk_decode_ref(vr, pr, k=vr.shape[1], p=P, group=group,
                                     kg=kg)
    errs = {"batched_topk_encode": 0.0, "batched_topk_decode": 0.0}
    for per in TP.PER_THREAD:
        plan = TP._plan(C, P, group, kg, aligned(x), per=per)
        v, pk = torch.empty_like(vr), torch.empty_like(pr)
        d = torch.empty((C, P), device=x.device)
        TP._encode(x, v, pk, group, kg, plan)
        TP._decode(vr, pr, d, group, kg, plan)
        torch.cuda.synchronize()
        shape = f"C={C} P={P} G={group} kg={kg} per={per}"
        check(exact(v, vr) and torch.equal(pk, pr),
              f"batched_topk_encode {shape}: differs from pack + bit-pack")
        check(exact(d, dr),
              f"batched_topk_decode {shape}: differs from bit-unpack + unpack")
        errs["batched_topk_encode"] = max(errs["batched_topk_encode"],
                                          exact_err(v, vr))
        errs["batched_topk_decode"] = max(errs["batched_topk_decode"],
                                          exact_err(d, dr))
    return errs


def malformed_decode(gen, dev, c, p, kg):
    """The decode on bit-planes of random bytes (local indices that repeat
    in a group, and past G where G is not a power of two; not at G = 8)
    against the one-stage bit-unpack and unpack kernels, bit for bit: a
    repeated index sums up to kg values in slot order, an order the plain
    version's reduction does not promise, so its difference is reported,
    not held. Returns that difference."""
    K = -(-p // GROUP) * kg
    bits = (GROUP - 1).bit_length()
    vals = torch.randn((c, K), generator=gen, device=dev)
    planes = torch.randint(0, 256, (c, bits * -(-K // 8)), generator=gen,
                           device=dev, dtype=torch.uint8)
    got = batched_topk_decode(vals, planes, k=K, p=p, group=GROUP, kg=kg)
    two = batched_topk_unpack(vals, batched_idx_bitunpack(
        planes, k=K, group=GROUP, kg=kg), p=p, group=GROUP, kg=kg)
    plain = REF.batched_topk_decode_ref(vals, planes, k=K, p=p, group=GROUP,
                                        kg=kg)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int32), two.view(torch.int32)),
          f"batched_topk_decode C={c} P={p} kg={kg} malformed planes: "
          "differs from bit-unpack + unpack")
    return float((got - plain).abs().max())


def codec_work(name, c, p, group, kg, chunk=256):
    """(bytes, operations) of one codec kernel call on (c, p) rows: the
    dense rows, kept values and int32 indices at 4 bytes each, the packed
    indices at their bits, int8 codes at 1 byte and their chunk scales at
    4. Operations: the group x group compare and the kg one-hot sums of a
    group; a few shifts and masks a slot; a product a code; all far below
    the bytes bound. Encode and decode move no int32 index, the int8
    decode no fp32 value."""
    nb = p // group
    k = nb * kg
    kb = (k + 7) // 8
    bits = (group - 1).bit_length()
    vec, ind, out, pk = 4.0 * c * k, 4.0 * c * k, 4.0 * c * p, c * bits * kb
    codes = c * k + 4.0 * c * -(-k // chunk)
    n_groups = c * nb
    pack = (4.0 * c * p + vec + ind, n_groups * (group * group
                                                 + 2 * group * kg))
    unpack = (vec + ind + out, n_groups * 2 * group * kg)
    bitpack = (ind + pk, c * kb * 8 * (2 + 3 * bits))
    bitunpack = (pk + ind, c * k * (2 + 3 * bits))
    return {"batched_topk_pack": pack, "batched_topk_unpack": unpack,
            "batched_idx_bitpack": bitpack,
            "batched_idx_bitunpack": bitunpack,
            "batched_topk_encode": (4.0 * c * p + vec + pk,
                                    pack[1] + bitpack[1]),
            "batched_topk_decode": (vec + pk + out,
                                    unpack[1] + bitunpack[1]),
            INT8_DECODE: (codes + pk + out,
                          unpack[1] + bitunpack[1] + c * k),
            }[name]


def codec_timings(x, peak):
    """At one (C, P) of rows ``x``: encode and decode beside their bounds,
    the four one-stage kernels, each pair as the two launches it replaces
    (timed together) and as the sum of its two times."""
    C, P = x.shape
    K = -(-P // GROUP) * KG
    vals, idx = batched_topk_pack(x, group=GROUP, kg=KG)
    packed = batched_idx_bitpack(idx, group=GROUP, kg=KG)
    one = {
        "batched_topk_pack": lambda: batched_topk_pack(x, group=GROUP,
                                                       kg=KG),
        "batched_idx_bitpack": lambda: batched_idx_bitpack(idx, group=GROUP,
                                                           kg=KG),
        "batched_idx_bitunpack": lambda: batched_idx_bitunpack(
            packed, k=K, group=GROUP, kg=KG),
        "batched_topk_unpack": lambda: batched_topk_unpack(
            vals, idx, p=P, group=GROUP, kg=KG)}
    out = {"shape": [C, P, GROUP, KG]}
    for name, fn in one.items():
        out[name] = {"ms": time_ms(fn),
                     "bound_ms": bound(*codec_work(name, C, P, GROUP, KG),
                                       peak)[0]}
    pairs = {
        "batched_topk_encode": (
            lambda: batched_topk_encode(x, group=GROUP, kg=KG),
            lambda: batched_idx_bitpack(batched_topk_pack(
                x, group=GROUP, kg=KG)[1], group=GROUP, kg=KG),
            ("batched_topk_pack", "batched_idx_bitpack")),
        "batched_topk_decode": (
            lambda: batched_topk_decode(vals, packed, k=K, p=P, group=GROUP,
                                        kg=KG),
            lambda: batched_topk_unpack(vals, batched_idx_bitunpack(
                packed, k=K, group=GROUP, kg=KG), p=P, group=GROUP, kg=KG),
            ("batched_idx_bitunpack", "batched_topk_unpack"))}
    for name, (fn, two, parts) in pairs.items():
        bd = bound(*codec_work(name, C, P, GROUP, KG), peak)
        ms = time_ms(fn)
        out[name] = {"ms": ms, "bound_ms": bd[0], "bound_share": bd[0] / ms,
                     "per_thread": TP._plan(C, P, GROUP, KG,
                                            aligned(x)).per,
                     "two_launches_ms": time_ms(two),
                     "sum_of_two_ms": sum(out[n]["ms"] for n in parts),
                     "replaces": list(parts)}
    return out


def int8_payload(gen, dev, c, p, kg, chunk, group=GROUP, nonfinite=False):
    """The int8 codec's sparse payload of ``codec_rows`` (c, p): the
    encode's values quantized per chunk -> (codes, scales, planes), with the
    int8 extremes (-128 among them) in row 0; ``nonfinite``: a NaN, a +inf
    and a -inf scale (the quantizer's for chunks holding them)."""
    vals, planes = batched_topk_encode(codec_rows(gen, dev, c, p),
                                       group=group, kg=kg)
    q, sc = REF.batched_quantize_ref(vals, chunk=chunk)
    q[0, :3] = torch.tensor([-128, 127, -127], dtype=torch.int8, device=dev)
    if nonfinite:
        nc = sc.shape[1]
        sc[0, min(1, nc - 1)] = float("nan")
        sc[-1, 0] = float("inf")
        sc[c // 2, nc - 1] = float("-inf")
    return q, sc, planes


def decode_int8_errs(q, sc, planes, p, kg, chunk, group=GROUP):
    """The int8 decode on (codes, scales, planes) against its plain version
    and against the two launches it replaces (dequantize, then decode),
    bit for bit (NaN where theirs is), planned and under each per-thread
    variant (forced, not counted). Returns the largest difference (0.0
    when they agree)."""
    C, K = q.shape
    kw = dict(k=K, p=p, group=group, kg=kg)
    got = batched_topk_decode_int8(q, sc, planes, chunk=chunk, **kw)
    plain = REF.batched_topk_decode_int8_ref(q, sc, planes, chunk=chunk, **kw)
    two = batched_topk_decode(batched_dequantize(q, sc, chunk=chunk), planes,
                              **kw)
    outs = [got]
    for per in TP.PER_THREAD:
        d = torch.empty((C, p), device=q.device)
        TP._decode_int8(q, sc, planes, d, group, kg, chunk,
                        TP._plan(C, p, group, kg, True, per=per))
        outs.append(d)
    torch.cuda.synchronize()
    shape = (f"C={C} P={p} G={group} kg={kg} chunk={chunk} K%16={K % 16}"
             f"{'' if bool(torch.isfinite(sc).all()) else ' non-finite'}"
             f"{'' if q.data_ptr() % 16 == 0 else ' misaligned'}")
    for i, d in enumerate(outs):
        what = "planned" if i == 0 else f"per={TP.PER_THREAD[i - 1]}"
        check(exact(d, plain), f"{INT8_DECODE} {shape} {what}: differs from "
              "the plain version")
        check(torch.equal(d.view(torch.int32), two.view(torch.int32)),
              f"{INT8_DECODE} {shape} {what}: differs from dequantize + "
              "decode")
    return max(exact_err(d, plain) for d in outs)


def decode_int8_timings(gen, dev, peak, c, p):
    """The int8 decode at (c, p) (chunk 256, kg KG) beside its bound, its
    plain version and the two launches it replaces (timed together and
    each alone; the dequantize also beside its plain version)."""
    q, sc, planes = int8_payload(gen, dev, c, p, KG, 256)
    kw = dict(k=q.shape[1], p=p, group=GROUP, kg=KG)
    vals = batched_dequantize(q, sc, chunk=256)
    bd = bound(*codec_work(INT8_DECODE, c, p, GROUP, KG), peak)
    ms = time_ms(lambda: batched_topk_decode_int8(q, sc, planes, **kw))
    deq = time_ms(lambda: batched_dequantize(q, sc, chunk=256))
    dec = time_ms(lambda: batched_topk_decode(vals, planes, **kw))
    return {"shape": [c, p, GROUP, KG, 256], "ms": ms, "bound_ms": bd[0],
            "bound_by": bd[1], "bound_share": bd[0] / ms,
            "bound_bytes": codec_work(INT8_DECODE, c, p, GROUP, KG)[0],
            "per_thread": TP._plan(c, p, GROUP, KG, True).per,
            "plain_ms": time_ms(lambda: REF.batched_topk_decode_int8_ref(
                q, sc, planes, **kw)),
            "two_launches_ms": time_ms(lambda: batched_topk_decode(
                batched_dequantize(q, sc, chunk=256), planes, **kw)),
            "dequantize_ms": deq, "decode_ms": dec,
            "sum_of_two_ms": deq + dec,
            "dequantize_plain_ms": time_ms(lambda: REF.batched_dequantize_ref(
                q, sc, chunk=256))}


def decode_int8_rows(gen, dev, peak):
    """The int8 decode held against its plain version and against
    dequantize + decode, bit for bit: the round's (5, 37696) and the
    fleet's (1000, 57664) payloads (K = 14136 and 21624, code rows 8 bytes
    off 16), ragged P (K odd), kg 1 / 3 / 8, chunks 256, 100 and 7, groups
    6 and 16, NaN and infinite scales, codes at a misaligned base, both
    per-thread variants; on malformed planes against the two launches.
    Timed at both path shapes (``by_shape``); the row's own time is the
    fleet's."""
    err = 0.0
    cases = [(N_CLIENTS, P_ROUND, KG, 256, GROUP),
             (SCALE_CLIENTS[-1], P_EDGE, KG, 256, GROUP)]
    cases += [(3, p, kg, chunk, GROUP) for p in (999, 8 * 2048 + 5)
              for kg in (1, 3, 8) for chunk in (256, 100)]
    cases += [(3, 40 * g + 3, kg, chunk, g) for g in (6, 16)
              for kg in (1, 3) for chunk in (256, 7)]
    for c, p, kg, chunk, g in cases:
        for nonfinite in (False, True):
            q, sc, planes = int8_payload(gen, dev, c, p, kg, chunk, g,
                                         nonfinite)
            err = max(err, decode_int8_errs(q, sc, planes, p, kg, chunk, g))
            if c <= N_CLIENTS:
                err = max(err, decode_int8_errs(offset_copy(q), sc, planes,
                                                p, kg, chunk, g))
    malformed = {}
    for c, p, kg in ((3, 999, 3), (N_CLIENTS, P_ROUND, KG)):
        q, sc, planes = int8_payload(gen, dev, c, p, kg, 256)
        bad = torch.randint(0, 256, planes.shape, generator=gen, device=dev,
                            dtype=torch.uint8)
        kw = dict(k=q.shape[1], p=p, group=GROUP, kg=kg)
        got = batched_topk_decode_int8(q, sc, bad, **kw)
        two = batched_topk_decode(batched_dequantize(q, sc), bad, **kw)
        plain = REF.batched_topk_decode_int8_ref(q, sc, bad, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), two.view(torch.int32)),
              f"{INT8_DECODE} C={c} P={p} kg={kg} malformed planes: differs "
              "from dequantize + decode")
        malformed[f"{c}x{p} kg {kg}"] = float((got - plain).abs().max())
    by_shape = [decode_int8_timings(gen, dev, peak, N_CLIENTS, P_ROUND),
                decode_int8_timings(gen, dev, peak, SCALE_CLIENTS[-1],
                                    P_EDGE)]
    fleet = by_shape[-1]
    return {INT8_DECODE: dict(
        max_abs_err=err, bound=(fleet["bound_ms"], fleet["bound_by"]),
        ms=fleet["ms"], plain_ms=fleet["plain_ms"], library_ms=None,
        shape=fleet["shape"],
        detail={"bound_bytes": fleet["bound_bytes"],
                "library": "none: no one PyTorch call dequantizes per chunk "
                "and scatters", "by_shape": by_shape,
                "malformed_planes_vs_plain": malformed})}


def topk_kernel_rows(gen, dev, peak):
    """The codec's six kernels held against their plain versions at the
    round's shape (C=5, P=37696), the fleet shape (C=1000, P=57664) and
    ragged P with kg 1, 3 and 8 (the tail group selects pad slots at kg 8),
    on rows with ties, zeros and an all-zero row, and on rows holding NaN
    and infinities (there encode and decode under both per-thread
    variants, at an aligned and a misaligned base, and at groups 2, 6 and
    16); the decode on malformed planes against the one-stage kernels. Timed at the fleet shape; encode and decode at the round's
    shape too, beside the one-stage kernels they replace."""
    names = CODEC_KERNELS + ONE_STAGE_CODEC
    errs = dict.fromkeys(names, 0.0)

    def fold(e):
        for n, v in e.items():
            errs[n] = max(errs[n], v)

    fold(topk_errs(codec_rows(gen, dev, N_CLIENTS, P_ROUND), KG))
    fold(topk_errs(codec_rows(gen, dev, N_CLIENTS, P_ROUND, aligned=False),
                   KG))
    for p in (999, 8 * 2048 + 5):
        for kg in (1, 3, 8):
            for x in (codec_rows(gen, dev, 3, p),
                      nonfinite_rows(gen, dev, 3, p)):
                fold(topk_errs(x, kg))
                fold(codec_variant_errs(x, kg))
                fold(codec_variant_errs(offset_copy(x), kg))
    fold(topk_errs(nonfinite_rows(gen, dev, N_CLIENTS, P_ROUND), KG))
    for group in (2, 6, 16):         # other group sizes: 1, 3 and 4 planes
        for kg in sorted({1, min(3, group), group}):
            x = nonfinite_rows(gen, dev, 3, 40 * group + 3)
            fold(codec_variant_errs(x, kg, group))
            fold(codec_variant_errs(codec_rows(gen, dev, 3, 600 * group),
                                    kg, group))
    malformed = {f"{c}x{p} kg {kg}": malformed_decode(gen, dev, c, p, kg)
                 for c, p, kg in ((3, 999, 3), (3, 999, 8),
                                  (N_CLIENTS, P_ROUND, KG))}
    C, P = SCALE_CLIENTS[-1], P_EDGE
    x = codec_rows(gen, dev, C, P)
    fold(topk_errs(x, KG))
    for c, p in ((N_CLIENTS, P_ROUND), (C, P)):
        check(TP._plan(c, p, GROUP, KG, True).vec,
              f"codec ({c}, {p}): encode / decode not on 16-byte accesses")
    by_shape = [codec_timings(codec_rows(gen, dev, N_CLIENTS, P_ROUND),
                              peak), codec_timings(x, peak)]
    nb = P // GROUP
    K = nb * KG
    vals, idx = batched_topk_pack(x, group=GROUP, kg=KG)
    packed = batched_idx_bitpack(idx, group=GROUP, kg=KG)
    specs = {
        "batched_topk_encode": (
            lambda: batched_topk_encode(x, group=GROUP, kg=KG),
            lambda: REF.batched_topk_encode_ref(x, group=GROUP, kg=KG),
            None),
        "batched_topk_decode": (
            lambda: batched_topk_decode(vals, packed, k=K, p=P, group=GROUP,
                                        kg=KG),
            lambda: REF.batched_topk_decode_ref(vals, packed, k=K, p=P,
                                                group=GROUP, kg=KG), None),
        "batched_topk_pack": (
            lambda: batched_topk_pack(x, group=GROUP, kg=KG),
            lambda: REF.batched_topk_pack_ref(x, group=GROUP, kg=KG),
            lambda: torch.topk(x.abs().view(C, nb, GROUP), KG, dim=-1)),
        "batched_topk_unpack": (
            lambda: batched_topk_unpack(vals, idx, p=P, group=GROUP, kg=KG),
            lambda: REF.batched_topk_unpack_ref(vals, idx, p=P, group=GROUP,
                                                kg=KG), None),
        "batched_idx_bitpack": (
            lambda: batched_idx_bitpack(idx, group=GROUP, kg=KG),
            lambda: REF.batched_idx_bitpack_ref(idx, group=GROUP, kg=KG),
            None),
        "batched_idx_bitunpack": (
            lambda: batched_idx_bitunpack(packed, k=K, group=GROUP, kg=KG),
            lambda: REF.batched_idx_bitunpack_ref(packed, k=K, group=GROUP,
                                                  kg=KG), None),
    }
    rows = {}
    for name, (kernel, plain, library) in specs.items():
        nbytes, ops_ = codec_work(name, C, P, GROUP, KG)
        detail = {"bound_bytes": nbytes, "library": (
            "torch.topk of |x| over groups: nearest call, indices only, no "
            "tie promise, no value gather") if library else "none"}
        if name in CODEC_KERNELS:
            detail.update(by_shape=by_shape, malformed_planes_vs_plain=(
                malformed if name == "batched_topk_decode" else None))
        rows[name] = dict(
            max_abs_err=errs[name], bound=bound(nbytes, ops_, peak),
            ms=time_ms(kernel), plain_ms=time_ms(plain),
            library_ms=time_ms(library) if library else None,
            shape=[C, P, GROUP, KG], detail=detail)
    return rows


def offset_copy(x):
    """``x`` copied to a base one element past an aligned boundary, so the
    kernels take their scalar paths where the vector ones would run."""
    out = torch.empty((x.numel() + 1,), dtype=x.dtype,
                      device=x.device)[1:].view(x.shape)
    out.copy_(x)
    return out


def dequantize_err(q, s, chunk):
    out_k = batched_dequantize(q, s, chunk=chunk)
    out_r = REF.batched_dequantize_ref(q, s, chunk=chunk)
    torch.cuda.synchronize()
    bad = int((out_k.view(torch.int32) != out_r.view(torch.int32)).sum())
    check(bad == 0, f"batched_dequantize {tuple(q.shape)} chunk={chunk}: "
          f"{bad} values differ from the plain version")
    return float((out_k - out_r).abs().max())


def combine_err(b, al, a):
    out_k = adaptive_combine(b, al, a)
    out_r = REF.adaptive_combine_ref(b, al, a)
    torch.cuda.synchronize()
    bits = torch.int16 if b.dtype == torch.bfloat16 else torch.int32
    bad = int((out_k.view(bits) != out_r.view(bits)).sum())
    check(bad == 0, f"adaptive_combine {tuple(b.shape)}: {bad} values "
          "differ from the plain version")
    return float((out_k - out_r).abs().max())


def plain_aggregate_err(w, th):
    out_k = relevance_aggregate(w, th)
    out_r = REF.relevance_aggregate_ref(w, th)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_k).all()), "relevance_aggregate: non-finite")
    err = float((out_k - out_r).abs().max())
    check(err <= AGG_TOL, f"relevance_aggregate R={w.shape[0]} C={w.shape[1]}"
          f" P={th.shape[1]}: max_abs_err {err} > {AGG_TOL}")
    return err


def new_kernel_rows(gen, dev, peak):
    """Three kernels of the host-engine slice (the fourth, the combine, is
    ``combine_tree_rows``') at their path shapes and ragged ones, timed at
    the fleet shapes: dequantize at C=1000 and the
    codec's K = 21624 (P = 57664); the plain aggregate at R = C = 1000 (its
    path shape, R <= 5 rows of C = 5, is launch-bound); the 2-D distances
    at 64 x 32768 x 64."""
    rows = {}
    Cf, P = SCALE_CLIENTS[-1], P_EDGE
    K = P // GROUP * KG

    # batched_dequantize: the round's dense keyframe and its residual K
    # (a tail chunk of 56), an all-zero chunk, code extremes, a misaligned
    # base, a chunk of 64 at a ragged P
    err = 0.0
    for c, p, chunk in ((N_CLIENTS, P_ROUND, 256),
                        (N_CLIENTS, P_ROUND // GROUP * KG, 256),
                        (3, 999, 256), (2, 37, 64)):
        x = 2.0 * torch.randn((c, p), generator=gen, device=dev)
        x[0, :chunk] = 0.0
        q, sc = REF.batched_quantize_ref(x, chunk=chunk)
        q[-1, :2] = torch.tensor([127, -127], dtype=torch.int8, device=dev)
        err = max(err, dequantize_err(q, sc, chunk),
                  dequantize_err(offset_copy(q), sc, chunk))
    q, sc = batched_quantize(torch.randn((Cf, K), generator=gen, device=dev),
                             chunk=256)
    err = max(err, dequantize_err(q, sc, 256))
    nc = sc.shape[1]
    rows["batched_dequantize"] = dict(
        max_abs_err=err,
        bound=bound(Cf * K + 4.0 * Cf * nc + 4.0 * Cf * K, 1.0 * Cf * K,
                    peak),
        ms=time_ms(lambda: batched_dequantize(q, sc, chunk=256)),
        plain_ms=time_ms(lambda: REF.batched_dequantize_ref(q, sc,
                                                            chunk=256)),
        library_ms=None, shape=[Cf, K, 256],
        detail={"library": "none: no one PyTorch call dequantizes per "
                "chunk"})

    # relevance_aggregate: the host round's rows (R <= C = 5) and ragged
    # R, C, P, at standard-normal parameters
    def rows_of(r, c):
        w = torch.rand((r, c), generator=gen, device=dev)
        return w / w.sum(1, keepdim=True)

    err = 0.0
    for r, c, p in AGG_PLAIN_EDGES:
        w = rows_of(r, c)
        th = torch.randn((c, p), generator=gen, device=dev)
        err = max(err, plain_aggregate_err(w, th))
        if p % 4 == 0:                        # a misaligned base: ragged
            err = max(err, plain_aggregate_err(w, offset_copy(th)))
    w = rows_of(Cf, Cf)
    th = torch.randn((Cf, P), generator=gen, device=dev)
    err = max(err, plain_aggregate_err(w, th))
    rows["relevance_aggregate"] = dict(
        max_abs_err=err,
        bound=bound(*aggregate_work(Cf, Cf, P, False), peak),
        ms=time_ms(lambda: relevance_aggregate(w, th)),
        plain_ms=time_ms(lambda: REF.relevance_aggregate_ref(w, th)),
        library_ms=time_ms(lambda: torch.mm(w, th)), shape=[Cf, Cf, P],
        detail={"library": "torch.mm(W, Theta), TF32 off",
                "by_shape": aggregate_timings(gen, dev, peak, False)})

    # pairwise_dist (2-D): one client of the fp32 serving shape, ragged
    # shapes
    name = "pairwise_dist"
    err = 0.0
    for qn, gn, f in ((7, 1000, 64), (5, 333, 40), (1, 1, 64),
                      (129, 257, 37)):
        qe, ge = unit_rows(gen, dev, qn, f), unit_rows(gen, dev, gn, f)
        err = max(err, dist_err(name, pairwise_dist, REF.pairwise_dist_ref,
                                qe, ge),
                  dist_variant_errs(name, qe, ge)[0],
                  dist_variant_errs(name, offset_copy(qe),
                                    offset_copy(ge))[0])
    q = unit_rows(gen, dev, BATCH, F)
    g = unit_rows(gen, dev, G_FP32, F)
    err = max(err, dist_err(name, pairwise_dist, REF.pairwise_dist_ref, q, g),
              dist_variant_errs(name, q, g)[0])
    rows[name] = dict(
        max_abs_err=err,
        bound=bound(*dist_work(name, 1, BATCH, G_FP32, F), peak),
        ms=time_ms(lambda: pairwise_dist(q, g)),
        plain_ms=time_ms(lambda: REF.pairwise_dist_ref(q, g)),
        library_ms=time_ms(lambda: dist_library(name, q, g)),
        shape=[BATCH, G_FP32, F],
        detail={"library": "torch.addmm with the norms",
                "variant": plan_of(PD, 1, BATCH, G_FP32, F, "fp32", True),
                **{f"{v}_ms": time_ms(lambda: dist_forced(name, v)(q, g))
                   for v in PD.VARIANTS}})
    return rows


# the combine over whole trees: the round's head (its 200 ids, P = 37696 a
# client) and the LM's full-width bf16 adaptive tree
ROUND_CLASSES = 200
LM_HEAD_LEAF = (2048, 152064)            # qwen3-1.7b's head, padded vocab
HOST_CALLS = 1000                       # combine() calls a host-time mean


def combine_work(bases):
    """(bytes, operations) of one combine over ``bases``' leaves: three
    reads and a write of each value, a product and a sum."""
    n = sum(t.numel() for t in bases)
    return 4.0 * sum(t.numel() * t.element_size() for t in bases), 2.0 * n


def combine_tree_err(bases, alphas, as_):
    """The tree kernel against the plain version, every leaf bit for bit."""
    outs = adaptive_combine_tree(bases, alphas, as_)
    want = REF.adaptive_combine_tree_ref(bases, alphas, as_)
    torch.cuda.synchronize()
    err = 0.0
    for i, (o, w) in enumerate(zip(outs, want)):
        bits = torch.int16 if o.dtype == torch.bfloat16 else torch.int32
        bad = int((o.view(bits) != w.view(bits)).sum())
        check(bad == 0, f"adaptive_combine_tree leaf {i} {tuple(o.shape)} "
              f"{o.dtype}: {bad} values differ from the plain version")
        if o.numel():
            err = max(err, float((o.float() - w.float()).abs().max()))
    return err


def combine_grad_check(bases, alphas, as_, gen):
    """``ops.adaptive_combine_tree``'s gradients (one ``_foreach_mul`` for
    alpha, one for B) against autograd's of the plain ``b * al + a``, leaf
    by leaf, bit for bit, with B needing a gradient and without."""
    gs = like(bases, gen)
    bits = lambda t: t.view(torch.int16 if t.dtype == torch.bfloat16
                            else torch.int32)
    for b_grad in (False, True):
        grads = []
        for tree_entry in (True, False):
            ins = [[t.detach().clone().requires_grad_(flag) for t in ts]
                   for ts, flag in ((bases, b_grad), (alphas, True),
                                    (as_, True))]
            keys = [f"{i:04d}" for i in range(len(gs))]
            trees = [dict(zip(keys, ts)) for ts in ins]
            out = (ops.adaptive_combine_tree(*trees) if tree_entry
                   else tree_map(REF.adaptive_combine_ref, *trees))
            torch.autograd.backward([out[k] for k in keys], gs)
            grads.append([t.grad for ts in ins for t in ts])
        torch.cuda.synchronize()
        for k, (x, y) in enumerate(zip(*grads)):
            check((x is None) == (y is None)
                  and (x is None or torch.equal(bits(x), bits(y))),
                  f"adaptive_combine_tree: gradient {k} (B needs one: "
                  f"{b_grad}) differs from autograd's of b * al + a")


def round_head(gen, clients):
    """The round's stacked head: ``clients`` heads drawn from ``gen``."""
    cfg = EM.EdgeModelConfig(n_classes=ROUND_CLASSES)
    heads = [EM.init_adaptive_layers(cfg, gen) for _ in range(clients)]
    return {k: torch.stack([h[k] for h in heads]) for k in heads[0]}


def lm_adaptive_tree(gen):
    """qwen3-1.7b's adaptive tree at full width (bf16), as ``lm_train``
    splits it from the seed's weights."""
    cfg = get_config(LM_ARCH)
    _, adaptive = split_params(cfg, lm.init_params(cfg, gen))
    return adaptive


def like(ts, gen):
    return [torch.randn(t.shape, generator=gen, device=t.device).to(t.dtype)
            for t in ts]


def host_us(fn):
    """Mean host microseconds of one call over HOST_CALLS calls after a
    warm-up, the card drained at both ends."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / HOST_CALLS * 1e6


def combine_tree_rows(gen, dev, peak):
    """The combine held bit for bit against its plain version: single
    leaves through the one-leaf entry (the round head's, ragged and
    misaligned ones, the LM's bf16 ones); trees through the tree entry on
    the round's head (stacked at C = 5 and as a stack of one; aligned and
    through ``offset_copy``), the LM's full-width bf16 tree, a mixed fp32 /
    bf16 tree with ragged, misaligned and empty leaves, and a tree past
    MAX_LEAVES; its gradients against autograd's of the plain expression.
    Timed on the head beside seven one-leaf launches, the plain version and
    ``torch._foreach_addcmul``, with the host time of a ``combine()`` call;
    on the LM's tree and on single large leaves. Each row's launches are
    read from the counter over one call."""
    err, by_shape, launches = 0.0, {}, {}

    def row(name, bases, alphas, as_, per_leaf=False, library=None):
        bd = bound(*combine_work(bases), peak)
        before = adaptive_combine_tree.launches
        adaptive_combine_tree(bases, alphas, as_)
        r = {"leaves": len(bases),
             "launches": adaptive_combine_tree.launches - before,
             "ms": time_ms(lambda: adaptive_combine_tree(bases, alphas,
                                                         as_)),
             "bound_ms": bd[0], "bound_by": bd[1],
             "plain_ms": time_ms(lambda: REF.adaptive_combine_tree_ref(
                 bases, alphas, as_))}
        if per_leaf:
            r["one_leaf_launches_ms"] = time_ms(lambda: [
                adaptive_combine(*x) for x in zip(bases, alphas, as_)])
        if library == "foreach":
            r["library_ms"] = time_ms(lambda: torch._foreach_addcmul(
                as_, bases, alphas))
        elif library == "addcmul":
            r["library_ms"] = time_ms(lambda: torch.addcmul(
                as_[0], bases[0], alphas[0]))
        by_shape[name] = r
        return r

    # single leaves: the round head's, a ragged one on misaligned bases
    # (the scalar path); bf16: the LM's head leaf, an MLP leaf, a ragged one
    for shape, dt in (((N_CLIENTS, CFG.proto_dim, CFG.hidden), torch.float32),
                      ((N_CLIENTS, 64), torch.float32),
                      ((CFG.feat_dim, 200), torch.float32),
                      ((1001,), torch.float32),
                      (LM_HEAD_LEAF, torch.bfloat16),
                      ((2048, 6144), torch.bfloat16),
                      ((1001,), torch.bfloat16)):
        b, al, a = (torch.randn(shape, generator=gen, device=dev).to(dt)
                    for _ in range(3))
        err = max(err, combine_err(b, al, a),
                  combine_err(offset_copy(b), al, offset_copy(a)))
        del b, al, a

    for clients in (N_CLIENTS, 1):
        head = round_head(gen, clients)
        check(sum(t[0].numel() for t in head.values()) == P_ROUND,
              f"round head: P != {P_ROUND}")
        bases = [t.contiguous() for t in tree_leaves(head)]
        alphas, as_ = like(bases, gen), like(bases, gen)
        err = max(err, combine_tree_err(bases, alphas, as_),
                  combine_tree_err([offset_copy(t) for t in bases], alphas,
                                   [offset_copy(t) for t in as_]))
        combine_grad_check(bases, alphas, as_, gen)
        r = row(f"head_c{clients}", bases, alphas, as_, per_leaf=True,
                library="foreach")
        B, al, A = (dict(zip(head, ts)) for ts in (bases, alphas, as_))
        trainable = [{k: t.clone().requires_grad_(True) for k, t in d.items()}
                     for d in (al, A)]
        r["host_us_combine"] = host_us(lambda: combine(B, *trainable))
        r["host_us_one_leaf_combines"] = host_us(
            lambda: tree_map(ops.adaptive_combine, B, *trainable))
        if clients == N_CLIENTS:
            head_row = r

    # the LM's full-width adaptive tree (bf16): values, gradients, time
    tree = lm_adaptive_tree(torch.Generator(device=dev).manual_seed(SEED))
    bases = tree_leaves(tree)
    alphas, as_ = like(bases, gen), like(bases, gen)
    err = max(err, combine_tree_err(bases, alphas, as_))
    combine_grad_check(bases, alphas, as_, gen)
    row("lm_bf16_tree", bases, alphas, as_)
    del tree, bases, alphas, as_
    torch.cuda.empty_cache()

    # a mixed tree: fp32 and bf16, ragged lengths around the spans, an empty
    # leaf, misaligned bases on every third leaf
    sizes = (1, 3, 4095, 4096, 4097, 8191, 8193, 0, 1001, 37 * 129)
    bases, alphas, as_ = [], [], []
    for k, n in enumerate(sizes * 2):
        dt = torch.float32 if k < len(sizes) else torch.bfloat16
        b, al, a = (torch.randn((n,), generator=gen, device=dev).to(dt)
                    for _ in range(3))
        if k % 3 == 1:
            b, a = offset_copy(b), offset_copy(a)
        bases.append(b)
        alphas.append(al)
        as_.append(a)
    before = adaptive_combine_tree.launches
    err = max(err, combine_tree_err(bases, alphas, as_))
    launches["mixed"] = adaptive_combine_tree.launches - before
    combine_grad_check(bases, alphas, as_, gen)
    check(launches["mixed"] == 2,
          f"adaptive_combine_tree: the mixed tree took {launches['mixed']} "
          "launches, expected 2 (one per dtype)")
    # past MAX_LEAVES: three launches of one dtype
    n_many = 2 * ACM.MAX_LEAVES + 22
    bases = [torch.randn((k % 37 + 1, 129), generator=gen, device=dev)
             for k in range(n_many)]
    alphas, as_ = like(bases, gen), like(bases, gen)
    bases[5], as_[70] = offset_copy(bases[5]), offset_copy(as_[70])
    before = adaptive_combine_tree.launches
    err = max(err, combine_tree_err(bases, alphas, as_))
    launches["past_max_leaves"] = adaptive_combine_tree.launches - before
    check(launches["past_max_leaves"] == 3,
          f"adaptive_combine_tree: {n_many} leaves took "
          f"{launches['past_max_leaves']} launches, expected 3")

    # single large leaves through the tree entry: the fleet's fp32 leaf and
    # the LM's bf16 head leaf
    for name, shape, dt in (("fleet_leaf", (SCALE_CLIENTS[-1], P_EDGE),
                             torch.float32),
                            ("lm_head_leaf", LM_HEAD_LEAF, torch.bfloat16)):
        xs = [[torch.randn(shape, generator=gen, device=dev).to(dt)]
              for _ in range(3)]
        row(name, *xs, library="addcmul")
        del xs

    r = head_row
    return {"adaptive_combine": dict(
        max_abs_err=err, bound=(r["bound_ms"], r["bound_by"]),
        ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
        shape=[N_CLIENTS, P_ROUND],
        detail={"library": "torch._foreach_addcmul(As, Bs, alphas); single "
                           "leaves torch.addcmul(A, B, alpha)",
                "by_shape": by_shape, "launches_by_tree": launches})}


# the dense LM's edge train step (lm_train): qwen3-1.7b at full width, the
# train_4k sequence (its global batch of 256 cut to 2 on one card)
LM_ARCH, LM_BATCH, LM_SEQ = "qwen3-1.7b", 2, 4096
LM_STEPS = 4                            # 1 warm-up + 3 timed
LM_TIE = 1e-4                           # launch/train.py's tie_lambda
FLASH_STAGES = ("flash_attention_fwd", "flash_attention_fwd_lse",
                "flash_attention_dq", "flash_attention_dkv")
FWD_STAGES = FLASH_STAGES[:2]
# each stage's bf16 tensor-core source, and its design floor over the
# bound: the split products over the bound's (forwards S, P_hi V, P_lo V
# against 2; dQ S, dP, dS_hi K, dS_lo K against 3; dK/dV S, dP, two for
# dV and two for dK against 4)
TC_SOURCE = {"flash_attention_fwd": "flash_fwd_sm90",
             "flash_attention_fwd_lse": "flash_fwd_sm90",
             "flash_attention_dq": "flash_bwd_sm90",
             "flash_attention_dkv": "flash_bwd_sm90"}
DESIGN_FLOOR = {"flash_attention_fwd": 1.5, "flash_attention_fwd_lse": 1.5,
                "flash_attention_dq": 4 / 3, "flash_attention_dkv": 1.5}
FLASH_PLAIN = {"flash_attention_fwd": REF.flash_attention_ref,
               "flash_attention_fwd_lse": REF.flash_attention_fwd_lse_ref,
               "flash_attention_dq": REF.flash_attention_dq_ref,
               "flash_attention_dkv": REF.flash_attention_dkv_ref}
# kernel vs plain: fp32 at the edge shapes, absolute (o and lse: online
# softmax in another order; grads: sums over up to 1000 keys)
FLASH_TOL = {"o": 2e-5, "lse": 1e-5, "grad": 5e-4}
# bf16 (the path shape and the train step's own operands), element by
# element: both sides round fp32 values that differ only in summation
# order, so they may differ by one bf16 rounding, and a bf16 ulp is at
# most 2^-7 |b|; a floor of 1e-3 of the output's rms covers fp32 order
# differences near zero. Each output's relative L2 error is held too, at
# 10x the largest reading on an H100 (1.03e-4; one rounding apart
# everywhere would be about 2^-8). lse stays fp32: absolute.
FLASH_BF16_ULP, FLASH_BF16_FLOOR, FLASH_BF16_REL_L2 = 2.0 ** -7, 1e-3, 1e-3
FLASH_BF16_LSE_TOL = 1e-4
# the bf16 edge shapes of all four stages (B, Hq, Hkv, Sq, Sk, hd, causal,
# window): the fp32 list, a causal R = 2 at hd 128, kv rows that no query
# sees (causal, Sq < Sk: kpos >= Sq), and rows that see no key (Sq > Sk,
# non-causal, window 5: qpos >= Sk + window - 1), and zamba2's head dim
# 80 (the wrappers pad it to 128 with the scale of 80)
BF16_EDGES = ((1, 2, 1, 16, 16, 64, True, 0), (1, 4, 2, 16, 16, 128, True, 0),
              (1, 2, 2, 1000, 1000, 128, True, 0),
              (1, 4, 2, 1000, 1000, 128, True, 0),
              (2, 4, 2, 1000, 1000, 64, True, 37),
              (1, 2, 1, 1000, 1000, 128, False, 0),
              (1, 2, 2, 130, 77, 64, False, 0),
              (1, 2, 1, 77, 130, 128, False, 5),
              (1, 4, 2, 77, 130, 64, True, 0),
              (1, 4, 2, 130, 77, 128, False, 5),
              (1, 4, 2, 130, 130, 80, True, 0),
              (1, 2, 1, 77, 130, 80, False, 5))
# the step on the kernels vs the same step on the plain versions, on the
# card: |loss delta|, and the relative L2 error of each adaptive gradient
# leaf (the worst leaf is held, so the attention weights' gradients,
# which dQ and dK/dV carry, are not drowned by the head's; the worst
# reading on an H100 is 1.2e-2, alpha of qnorm)
LM_SWAP_LOSS_TOL, LM_SWAP_GRAD_TOL = 2e-2, 2e-2
# lm_train_reduced: the GQA-reduced config (fp32), card vs CPU per step
LM_RED_STEPS, LM_RED_BATCH, LM_RED_SEQ, LM_RED_TOL = 10, 4, 200, 1e-4


def lm_path_flash_shapes():
    """The flash shapes (B, Hq, Hkv, Sq, Sk, hd, causal, window) that the
    lm_decode and lm_families paths send at full width: the gates'
    teacher-forced forwards and the families' split train steps, all
    causal with no window."""
    runs = [(get_config(DECODE_ARCH), DECODE_GATE_BATCH, DECODE_GATE_SEQ)]
    for arch in FAMILY_ARCHS:
        cfg = family_config(arch)
        runs.append((cfg, FAMILY_GATE_BATCH, FAMILY_GATE_SEQ))
        if cfg.family in ("ssm", "hybrid"):
            runs.append((cfg, FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ))
    return sorted({(B, c.n_heads, c.n_kv_heads, S, S, c.hd, True, 0)
                   for c, B, S in runs if any(attention_layers(c))})


def flash_inputs(gen, dev, B, hq, hkv, sq, sk, hd, dtype):
    q, do = (torch.randn((B, hq, sq, hd), generator=gen, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((B, hkv, sk, hd), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v, do


def flash_stats(q, k, v, do, kw):
    """The backward stages' fp32 inputs from the plain forward: lse and
    delta = rowsum(O dO)."""
    o, lse = REF.flash_attention_fwd_lse_ref(q, k, v, **kw)
    return lse, torch.sum(o.float() * do.float(), -1)


def flash_readings(a, b, tol):
    """One flash output ``a`` against the plain version's ``b``: against
    the absolute bar ``tol``, or where ``tol`` is None element by element
    against FLASH_BF16_ULP |b| + FLASH_BF16_FLOOR rms(b) and by its
    relative L2 error. -> {max_abs_err, bar_share (the largest share of a
    bar used), and for bf16 elem_share and rel_l2}."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    out = {"max_abs_err": float(diff.max())}
    if tol is not None:
        out["bar_share"] = out["max_abs_err"] / tol
    else:
        rms = float(torch.sqrt(torch.mean(b * b)))
        bar = FLASH_BF16_ULP * b.abs() + FLASH_BF16_FLOOR * rms
        out["elem_share"] = float((diff / bar.clamp(min=1e-30)).max())
        out["rel_l2"] = float(torch.linalg.vector_norm(diff)) / max(
            float(torch.linalg.vector_norm(b)), 1e-30)
        out["bar_share"] = max(out["elem_share"],
                               out["rel_l2"] / FLASH_BF16_REL_L2)
    return out


def flash_output_check(label, a, b, tol):
    """``flash_readings``, held: finite and every bar_share <= 1."""
    check(bool(torch.isfinite(a).all()), f"{label}: non-finite output")
    out = flash_readings(a, b, tol)
    check(out["bar_share"] <= 1.0, f"{label}: {out} over its bar")
    return out


def flash_outputs_check(label, name, got, want, bf16):
    """Every output of one stage held by ``flash_output_check`` (lse
    absolute); -> the worst of each reading over the outputs."""
    worst = {}
    for i, (a, b) in enumerate(zip(got, want)):
        is_lse = name == "flash_attention_fwd_lse" and i == 1
        tol = FLASH_BF16_LSE_TOL if is_lse else None
        if not bf16:
            tol = FLASH_TOL["lse" if is_lse else (
                "o" if name in FLASH_STAGES[:2] else "grad")]
        for key, x in flash_output_check(f"{label} {name} output {i}", a, b,
                                         tol).items():
            worst[key] = max(worst.get(key, 0.0), x)
    return worst


def flash_errs(q, k, v, do, kw, bf16):
    """Each of the four kernels against its plain version on one set of
    operands, each output held to its bar (``flash_outputs_check``);
    -> ({stage: worst readings}, {stage: the kernel's outputs})."""
    lse_r, delta = flash_stats(q, k, v, do, kw)
    got = {"flash_attention_fwd": (flash_attention_fwd(q, k, v, **kw),),
           "flash_attention_fwd_lse": flash_attention_fwd_lse(q, k, v, **kw),
           "flash_attention_dq": (flash_attention_dq(
               q, k, v, do, lse_r, delta, **kw),),
           "flash_attention_dkv": flash_attention_dkv(
               q, k, v, do, lse_r, delta, **kw)}
    want = {"flash_attention_fwd": (REF.flash_attention_ref(q, k, v, **kw),),
            "flash_attention_fwd_lse": REF.flash_attention_fwd_lse_ref(
                q, k, v, **kw),
            "flash_attention_dq": (REF.flash_attention_dq_ref(
                q, k, v, do, lse_r, delta, **kw),),
            "flash_attention_dkv": REF.flash_attention_dkv_ref(
                q, k, v, do, lse_r, delta, **kw)}
    torch.cuda.synchronize()
    label = f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} {kw}"
    return ({name: flash_outputs_check(label, name, got[name], want[name],
                                       bf16) for name in FLASH_STAGES}, got)


def blind_rows_check(got, sq, sk, kw):
    """The bf16 kernels' outputs where the mask leaves nothing: a q row
    that sees no key has o and dQ 0 and lse -1e30, a kv row that no query
    sees dK and dV 0, exactly; a row that sees a key has o not 0."""
    mask = REF.flash_mask(sq, sk, device=got["flash_attention_dq"][0].device,
                          **kw)
    blind, unseen = mask.sum(-1) == 0, mask.sum(0) == 0
    o, lse = got["flash_attention_fwd_lse"]
    dq, = got["flash_attention_dq"]
    dk, dv = got["flash_attention_dkv"]
    check(bool((o[:, :, blind] == 0).all())
          and bool((lse[:, :, blind] == REF.FLASH_NEG_INF).all())
          and bool((dq[:, :, blind] == 0).all())
          and bool((o[:, :, ~blind].abs().sum(-1) > 0).all()),
          f"bf16 flash at Sq {sq}, Sk {sk} {kw}: rows that see no key are "
          "not o = dQ = 0 with lse -1e30")
    check(bool((dk[:, :, unseen] == 0).all())
          and bool((dv[:, :, unseen] == 0).all()),
          f"bf16 flash at Sq {sq}, Sk {sk} {kw}: kv rows that no query sees "
          "have dK or dV not 0")
    return int(blind.sum()), int(unseen.sum())


def sass_report(source):
    """What ``cuobjdump`` reads in csrc/<source>.cu's library: the HGMMA
    (wgmma), HMMA (mma.sync) and FFMA instructions in its SASS, and the
    most registers, local memory and stack (ptxas's spills) of any of its
    kernels, then each kernel's (registers are those a thread has at
    launch, before any setmaxnreg)."""
    def dump(flag):
        return subprocess.run(
            [str(Path(_build._nvcc()).parent / "cuobjdump"), flag,
             str(_build.build_dir() / f"lib{source}.so")],
            capture_output=True, text=True, timeout=300, check=True).stdout
    usage = dump("-res-usage")
    regs, local, stack = (list(map(int, re.findall(rf"{k}:(\d+)", usage)))
                          for k in ("REG", "LOCAL", "STACK"))
    check(bool(regs and local), f"{source}: no resource usage in {usage}")
    sass = dump("-sass")
    by_kernel = {m[0]: {"registers": int(m[1]), "stack_bytes": int(m[2]),
                        "local_bytes": int(m[3])}
                 for m in re.findall(r"Function ([^\s:]+):\s*REG:(\d+) "
                                     r"STACK:(\d+) SHARED:\d+ LOCAL:(\d+)",
                                     usage)}
    return {"hgmma": sass.count("HGMMA"), "hmma": sass.count("HMMA"),
            "ffma": sass.count("FFMA"),
            "registers": max(regs), "local_bytes": max(local),
            "stack_bytes": max(stack, default=0), "by_kernel": by_kernel}


def flash_kernel_rows(gen, dev, peak):
    """The four flash-attention kernels against their plain versions: fp32
    at edge shapes (S 16 and 1000, ragged S, hd 64 and 128, R 1 and 2,
    non-causal with Sq != Sk, a window), all four in bf16 (the tensor-core
    kernels) at ``BF16_EDGES``, all four in both dtypes at the shapes of
    the lm_decode and lm_families paths (``lm_path_flash_shapes``), and
    in bf16 at the train step's shape (B 2, 16 q / 8 kv heads, S 4096, hd
    128, causal), where they are timed beside their plain versions and
    PyTorch's ``scaled_dot_product_attention``
    (forward; its autograd backward for dQ and dK/dV). Bounds at the bf16
    tensor-core rate."""
    errs = dict.fromkeys(FLASH_STAGES, 0.0)

    def fold(e):
        for n, r in e.items():
            errs[n] = max(errs[n], r["max_abs_err"])

    for B, hq, hkv, sq, sk, hd, causal, window in (
            (1, 2, 1, 16, 16, 64, True, 0), (1, 4, 2, 16, 16, 128, True, 0),
            (1, 2, 2, 1000, 1000, 128, True, 0),
            (2, 4, 2, 1000, 1000, 64, True, 37),
            (1, 2, 1, 1000, 1000, 128, False, 0),
            (1, 2, 2, 130, 77, 64, False, 0),
            (1, 2, 1, 77, 130, 128, False, 5),
            (1, 4, 4, 77, 77, 80, True, 0)):
        q, k, v, do = flash_inputs(gen, dev, B, hq, hkv, sq, sk, hd,
                                   torch.float32)
        fold(flash_errs(q, k, v, do, dict(causal=causal, window=window),
                        False)[0])
    fp32_errs = dict(errs)
    # all four in bf16 (the tensor-core kernels) at the edge shapes, at
    # the bf16 bars, with rows that see no key and kv rows that no query
    # sees
    sass = {src: sass_report(src) for src in sorted(set(TC_SOURCE.values()))}
    for src, r in sass.items():
        check(r["hgmma"] > 0, f"{src}: no HGMMA in its SASS {r}")
    bf16_edge, masked = {}, [0, 0]
    for B, hq, hkv, sq, sk, hd, causal, window in BF16_EDGES:
        q, k, v, do = flash_inputs(gen, dev, B, hq, hkv, sq, sk, hd,
                                   torch.bfloat16)
        kw = dict(causal=causal, window=window)
        e, got = flash_errs(q, k, v, do, kw, True)
        fold(e)
        for n, r in e.items():
            bf16_edge[n] = {key: max(bf16_edge.get(n, {}).get(key, 0.0), x)
                            for key, x in r.items()}
        masked = [a + b for a, b in zip(masked,
                                        blind_rows_check(got, sq, sk, kw))]
    check(all(masked), f"BF16_EDGES hold no blind q row or no unseen kv "
          f"row: {masked}")
    # the shapes that lm_decode and lm_families send, all four stages in
    # fp32 (the FMA kernels) and in bf16 (the tensor-core kernels)
    lm_paths = {name: {} for name in FLASH_STAGES}
    for shape in lm_path_flash_shapes():
        B, hq, hkv, sq, sk, hd, causal, window = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_inputs(gen, dev, B, hq, hkv, sq, sk, hd,
                                       dtype)
            e = flash_errs(q, k, v, do, dict(causal=causal, window=window),
                           dtype == torch.bfloat16)[0]
            fold(e)
            for n, r in e.items():
                lm_paths[n][f"{list(shape)} {dtype}"] = r
    hq, hkv, hd = 16, 8, 128
    q, k, v, do = flash_inputs(gen, dev, LM_BATCH, hq, hkv, LM_SEQ, LM_SEQ,
                               hd, torch.bfloat16)
    kw = dict(causal=True, window=0)
    bf16_errs = flash_errs(q, k, v, do, kw, True)[0]
    fold(bf16_errs)
    lse, delta = flash_stats(q, k, v, do, kw)

    pairs = LM_BATCH * hq * LM_SEQ * (LM_SEQ + 1) / 2   # visible (q, k)
    el_q, el_kv = q.numel(), k.numel()
    stats = 4.0 * LM_BATCH * hq * LM_SEQ
    work = {   # (bytes: inputs once, outputs once; flops)
        "flash_attention_fwd": (2.0 * (2 * el_q + 2 * el_kv),
                                4.0 * pairs * hd),
        "flash_attention_fwd_lse": (2.0 * (2 * el_q + 2 * el_kv) + stats,
                                    4.0 * pairs * hd),
        "flash_attention_dq": (2.0 * (3 * el_q + 2 * el_kv) + 2 * stats,
                               6.0 * pairs * hd),
        "flash_attention_dkv": (2.0 * (2 * el_q + 4 * el_kv) + 2 * stats,
                                8.0 * pairs * hd)}
    calls = {
        "flash_attention_fwd": (
            lambda: flash_attention_fwd(q, k, v, **kw),
            lambda: REF.flash_attention_ref(q, k, v, **kw)),
        "flash_attention_fwd_lse": (
            lambda: flash_attention_fwd_lse(q, k, v, **kw),
            lambda: REF.flash_attention_fwd_lse_ref(q, k, v, **kw)),
        "flash_attention_dq": (
            lambda: flash_attention_dq(q, k, v, do, lse, delta, **kw),
            lambda: REF.flash_attention_dq_ref(q, k, v, do, lse, delta,
                                               **kw)),
        "flash_attention_dkv": (
            lambda: flash_attention_dkv(q, k, v, do, lse, delta, **kw),
            lambda: REF.flash_attention_dkv_ref(q, k, v, do, lse, delta,
                                                **kw))}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd = time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
    # SDPA (single-rounded P and dS) against the plain versions: reported,
    # not held
    sdpa_vs_plain = flash_readings(
        sdpa(q, k, v, is_causal=True, enable_gqa=True),
        REF.flash_attention_ref(q, k, v, **kw), None)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    og = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(og, (qg, kg, vg), do,
                                                   retain_graph=True))
    sdpa_grads = torch.autograd.grad(og, (qg, kg, vg), do)
    plain_dk, plain_dv = REF.flash_attention_dkv_ref(q, k, v, do, lse, delta,
                                                     **kw)
    sdpa_bwd_vs_plain = {
        "flash_attention_dq": {"dq": flash_readings(
            sdpa_grads[0], REF.flash_attention_dq_ref(q, k, v, do, lse, delta,
                                                      **kw), None)},
        "flash_attention_dkv": {
            "dk": flash_readings(sdpa_grads[1], plain_dk, None),
            "dv": flash_readings(sdpa_grads[2], plain_dv, None)}}
    del og, qg, kg, vg, sdpa_grads, plain_dk, plain_dv
    rows = {}
    for name in FLASH_STAGES:
        fn, plain = calls[name]
        b = bound(*work[name], tensor_peak(peak))
        rows[name] = dict(
            max_abs_err=errs[name], bound=b,
            ms=time_ms(fn), plain_ms=time_ms(plain),
            library_ms=sdpa_fwd if name in FWD_STAGES else sdpa_bwd,
            shape=[LM_BATCH, hq, hkv, LM_SEQ, hd],
            detail={"fp32_edge_abs_err": fp32_errs[name],
                    "bf16_path_shape": bf16_errs[name],
                    "kernel": f"tensor cores ({TC_SOURCE[name]}.cu) in bf16, "
                              "FMA (flash_attention.cu) in fp32",
                    "bf16_edge": bf16_edge[name],
                    "lm_path_shapes": lm_paths[name],
                    "sass": sass[TC_SOURCE[name]],
                    "design_floor_ms": DESIGN_FLOOR[name] * b[0],
                    "sdpa_vs_plain": sdpa_vs_plain if name in FWD_STAGES
                    else sdpa_bwd_vs_plain[name],
                    "library": (
                "scaled_dot_product_attention(is_causal, enable_gqa)"
                if name in FWD_STAGES else
                "its autograd backward (dQ, dK and dV together)"),
                    "bound_peak": "bf16 tensor cores"})
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------


def _l2n(x):
    return x / np.sqrt(np.maximum((x * x).sum(-1, keepdims=True), 1e-12))


def clustered_gallery(rng, G):
    """(G, proto_dim) rows around G // N_PER_ID unit id centers living in a
    rank-ID_RANK subspace (the recipe of benchmarks/serve_bench.py)."""
    U, _ = np.linalg.qr(rng.standard_normal((CFG.proto_dim, ID_RANK)))
    z = _l2n(rng.standard_normal((G // N_PER_ID, ID_RANK))).astype(np.float32)
    centers = _l2n(z @ U.T.astype(np.float32))
    idx = np.repeat(np.arange(G // N_PER_ID), N_PER_ID)
    noise = _l2n(rng.standard_normal((G, CFG.proto_dim))).astype(np.float32)
    return _l2n(centers[idx] + ID_RHO * noise).astype(np.float32), centers


def mk_query(rng, centers_c):
    ctr = int(rng.integers(len(centers_c)))
    noise = _l2n(rng.standard_normal(CFG.proto_dim)).astype(np.float32)
    return _l2n(centers_c[ctr] + ID_RHO * noise).astype(np.float32), ctr


def query_set(rng, centers, n):
    """(C, n, proto_dim) clustered queries + their person ids."""
    qp = np.zeros((C, n, CFG.proto_dim), np.float32)
    qids = np.zeros((C, n), np.int64)
    for c in range(C):
        for b in range(n):
            qp[c, b], qids[c, b] = mk_query(rng, centers[c])
    return qp, qids


def phase_serve(mode, G, dev, card):
    rng = np.random.default_rng(SEED)
    protos, centers = zip(*(clustered_gallery(rng, G) for _ in range(C)))
    ids = [np.arange(G, dtype=np.int32) for _ in range(C)]
    t0 = time.perf_counter()
    index = GalleryIndex(protos, ids, keep_fp32=(mode == "fp32"),
                         nlist="auto" if mode == "ivf" else 0, device=dev)
    engine = RetrievalEngine(index, stacked_heads(CFG, C, SEED, dev), k=K,
                             mode=mode, nprobe=NPROBE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stream = []
    for i in range(N_QUERIES):
        c = int(rng.integers(C))
        stream.append((c, mk_query(rng, centers[c])[0], i))
    batcher = ContinuousBatcher(engine, batch=BATCH)
    batcher.submit(0, stream[0][1])
    batcher.drain()                                       # warmup launch
    half = N_QUERIES // 2
    r1 = run_closed_loop(batcher, stream[:half])
    tr = time.perf_counter()
    engine.update(stacked_heads(CFG, C, SEED + 1, dev))   # a round lands
    torch.cuda.synchronize()
    refresh_ms = (time.perf_counter() - tr) * 1e3
    r2 = run_closed_loop(batcher, stream[half:])
    tickets = r1["tickets"] + r2["tickets"]
    check(len(tickets) == N_QUERIES, f"serve_{mode}: {len(tickets)} answers")
    for t in tickets:
        check(t.ids.shape == (K,) and bool((t.ids >= 0).all())
              and bool(np.isfinite(t.dists).all()),
              f"serve_{mode}: malformed answer for query {t.qid}")
    lat = np.array([t.latency for t in tickets]) * 1e3
    wall = r1["wall_s"] + r2["wall_s"]
    rec = {"phase": f"serve_{mode}", "card": card, "clients": C, "gallery": G,
           "batch": BATCH, "k": K, "queries": len(tickets),
           "qps": len(tickets) / wall, "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "qps_pre_update": r1["qps"], "qps_post_update": r2["qps"],
           "refresh_ms": refresh_ms, "index_build_s": build_s,
           "resident_mb": index.resident_bytes(mode) / 1e6}
    if mode == "ivf":
        rec.update(nlist=index.nlist, bcap=index.bcap, nprobe=engine.nprobe,
                   ivf_iters=index.ivf_iters,
                   ivf_train_cap=index.ivf_train_cap,
                   ivf_balance=index.ivf_balance)
    emit(rec)
    return engine, stream, r2["tickets"], centers, rng, rec


# ---------------------------------------------------------------------------
# phase 6: parity
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def patched_ops(new):
    """Route ``ops.<name>`` to ``new[name]`` inside the block."""
    orig = {n: getattr(ops, n) for n in new}
    for n, fn in new.items():
        setattr(ops, n, fn)
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(ops, n, fn)


def plain_query(engine, qp, qmask):
    """The engine's current state rebuilt and queried with the plain
    versions on the same device; the plain int8 image must equal the
    served one bit for bit. The IVF image comes from the int8 codes by
    plain gathers (and is bit-identical from refresh to refresh, see
    serve_ivf_checks); ivf queries it through the plain probe selection
    and shortlist."""
    ix = engine.index
    fn, mu, sd = index_features(engine.theta, ix.gp_dev, (ix.gids >= 0).float())
    Cn, G, Fn = fn.shape
    if engine.mode in ("int8", "ivf"):
        q8, s = REF.batched_quantize_ref(fn.reshape(Cn, G * Fn), chunk=Fn)
        gq = q8.reshape(Cn, G, Fn)
        check(torch.equal(gq, ix.gq) and torch.equal(s, ix.gscale),
              "plain int8 image differs from the served one")
    if engine.mode == "ivf":
        with patched_ops({
                "batched_cluster_assign": REF.batched_cluster_assign_ref,
                "batched_ivf_shortlist": REF.batched_ivf_shortlist_ref}):
            ids, d = query_ivf(engine.theta, mu, sd, qp, qmask, ix.cent,
                               ix.cn2, ix.bq, ix.pack, k=engine.k,
                               nprobe=engine.nprobe)
        return ids.cpu().numpy(), d.cpu().numpy()
    qf = featurize(engine.theta, mu, sd, qp)
    if engine.mode == "int8":
        gn2 = torch.sum(torch.square(gq.float()), -1) * torch.square(s)
        dist = REF.batched_int8_pairwise_dist_ref(qf, gq, s, gn2)
    else:
        dist = REF.batched_pairwise_dist_ref(qf, fn)
    ids, d = rank_topk(dist, ix.gids, qmask, engine.k)
    return ids.cpu().numpy(), d.cpu().numpy()


def served_vs_plain(engine, stream, tickets, dev):
    """The post-update answers the batcher served vs the plain engine."""
    by_c = [[t for t in tickets if t.client == c] for c in range(C)]
    B = max(len(r) for r in by_c)
    qp = np.zeros((C, B, CFG.proto_dim), np.float32)
    qmask = np.zeros((C, B), np.float32)
    ids = np.full((C, B, K), -1, np.int32)
    dists = np.zeros((C, B, K), np.float32)
    for c, row in enumerate(by_c):
        for b, t in enumerate(row):
            qp[c, b], qmask[c, b] = stream[t.qid][1], 1.0
            ids[c, b], dists[c, b] = t.ids, t.dists
    ids_p, d_p = plain_query(engine, torch.from_numpy(qp).to(dev),
                             torch.from_numpy(qmask).to(dev))
    valid = qmask > 0
    return (recall_at_k(ids, ids_p, qmask),
            float(np.abs(dists[valid] - d_p[valid]).max()))


def phase_breakdown(served, card):
    """Where one full (C, 64) query launch spends its time, stage by stage
    (device times, as in phase 3), beside the host wall time of the whole
    ``query_batch`` call."""
    for mode, (engine, stream, _, _, _, _) in served.items():
        ix = engine.index
        qp_np = np.stack([np.stack([stream[(c * BATCH + b) % N_QUERIES][1]
                                    for b in range(BATCH)]) for c in range(C)])
        qmask_np = np.ones((C, BATCH), np.float32)
        qp = torch.from_numpy(qp_np).to(ix.device)
        qmask = torch.from_numpy(qmask_np).to(ix.device)
        qf = featurize(engine.theta, ix.bn_mu, ix.bn_sd, qp)
        stages = {}
        if mode == "ivf":
            assign = lambda: ops.batched_cluster_assign(qf, ix.cent, ix.cn2,
                                                        nprobe=engine.nprobe)
            probe = assign()
            score = lambda: batched_ivf_shortlist_scores(qf, probe, ix.bq,
                                                         ix.pack)
            d, sl_ids = ops.batched_ivf_shortlist(qf, probe, ix.bq, ix.pack)
            rank = lambda: rank_shortlist(d, sl_ids, qf, qmask, K)
            stages = {"assign_ms": time_ms(assign),
                      "cluster_kernel_ms": time_ms(lambda: batched_cluster_dist(
                          qf, ix.cent, ix.cn2)),
                      "candidates_per_query": int(d.shape[-1])}
        else:
            if mode == "int8":
                score = lambda: batched_int8_pairwise_dist(qf, ix.gq,
                                                           ix.gscale, ix.gn2)
            else:
                score = lambda: batched_pairwise_dist(qf, ix.gf)
            dist = score()
            rank = lambda: rank_topk(dist, ix.gids, qmask, K)
        ids = rank()[0]
        walls = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            engine.query_batch(qp_np, qmask_np)
            walls.append((time.perf_counter() - t0) * 1e3)
        emit({"phase": "serve_breakdown", "card": card, "mode": mode,
              "gallery": ix.capacity, "queries": C * BATCH,
              "featurize_ms": time_ms(
                  lambda: featurize(engine.theta, ix.bn_mu, ix.bn_sd, qp)),
              **stages, "score_ms": time_ms(score), "rank_ms": time_ms(rank),
              "readback_ms": time_ms(lambda: ids.cpu()),
              "query_batch_wall_ms": float(np.median(walls))})


def persons(ids):
    return np.where(ids >= 0, ids // N_PER_ID, -1)


def phase_parity(served, dev, card, launches):
    out = {"phase": "parity", "card": card}
    for mode, (engine, stream, tickets, _, _, _) in served.items():
        rec, derr = served_vs_plain(engine, stream, tickets, dev)
        out[f"{mode}_recall_vs_plain"] = rec
        out[f"{mode}_dist_err_vs_plain"] = derr
        check(rec >= MIN_RECALL and derr <= SERVE_DIST_TOL,
              f"{mode}: served vs plain engine recall {rec}, dist err {derr}")

    engf, _, _, centers, rng, _ = served["fp32"]
    qp, _ = query_set(rng, centers, N_HOST)
    qm = np.ones((C, N_HOST), np.float32)
    ids_d, d_d = engf.query_batch(qp, qm)
    ids_h, d_h = engf.query_host(qp, qm)
    rec, derr = recall_at_k(ids_d, ids_h, qm), float(np.abs(d_d - d_h).max())
    out.update(fp32_recall_vs_host=rec, fp32_dist_err_vs_host=derr)
    check(rec >= MIN_RECALL and derr <= SERVE_DIST_TOL,
          f"fp32 vs numpy host oracle: recall {rec}, dist err {derr}")

    G = engf.index.capacity
    eng8 = RetrievalEngine(engf.index, engf.theta, k=K, mode="int8",
                           refresh=False)
    qp, qids = query_set(rng, centers, N_MAP)
    qm = np.ones((C, N_MAP), np.float32)
    i8, _ = eng8.query_batch(qp, qm, k=G)
    i32, _ = engf.query_batch(qp, qm, k=G)
    m8 = float(np.mean([map_from_ranked_ids(persons(i8[c]), qids[c])
                        for c in range(C)]))
    m32 = float(np.mean([map_from_ranked_ids(persons(i32[c]), qids[c])
                         for c in range(C)]))
    out.update(map_int8=m8, map_fp32=m32, map_delta=abs(m8 - m32),
               map_gallery=G)
    check(m32 > 0.0 and abs(m8 - m32) <= MAP_TOLERANCE,
          f"int8-vs-fp32 mAP delta {abs(m8 - m32)} (fp32 mAP {m32})")

    out["launches"] = launches
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched in phases 4-5: {launches}")
    emit(out)


# ---------------------------------------------------------------------------
# phase 7b: IVF shortlist serving
# ---------------------------------------------------------------------------


def ivf_path_errs(seen):
    """Both IVF kernels against their plain versions on the operands of
    their last call on the serve_ivf path (the post-update image)."""
    qf, cent, cn2 = seen["batched_cluster_assign"]
    return {"batched_cluster_dist": dist_err(
                "batched_cluster_dist (serve_ivf)", batched_cluster_dist,
                REF.batched_cluster_dist_ref, qf, cent, cn2),
            "batched_ivf_shortlist_scores": shortlist_err(
                *seen["batched_ivf_shortlist"])}


def image_bits(ix):
    """The IVF image as bit patterns (fp32 viewed as int32)."""
    return {n: getattr(ix, n).view(torch.int32)
            if getattr(ix, n).dtype == torch.float32 else getattr(ix, n)
            for n in ("cent", "cn2", "bq", "pack", "binv")}


def full_probe_vs_int8(dev):
    """nprobe = nlist scores every bucket: the shortlist is the whole
    gallery, so the ivf path must return the exact int8 path's ids (as sets:
    the two sum |q|^2 + n2 - 2 q.g in another association, so rows within
    an ulp may swap ranks) and its distances."""
    rng = np.random.default_rng(SEED + 2)
    protos, centers = zip(*(clustered_gallery(rng, G_FULL_PROBE)
                            for _ in range(C)))
    ids = [np.arange(G_FULL_PROBE, dtype=np.int32) for _ in range(C)]
    index = GalleryIndex(protos, ids, keep_fp32=False, nlist="auto",
                         device=dev)
    engv = RetrievalEngine(index, stacked_heads(CFG, C, SEED, dev), k=K,
                           mode="ivf", nprobe=index.nlist)
    eng8 = RetrievalEngine(index, engv.theta, k=K, mode="int8", refresh=False)
    qp, _ = query_set(rng, centers, BATCH)
    qm = np.ones((C, BATCH), np.float32)
    iv, dv = engv.query_batch(qp, qm)
    i8, d8 = eng8.query_batch(qp, qm)
    out = {"gallery": G_FULL_PROBE, "nlist": index.nlist, "bcap": index.bcap,
           "recall": recall_at_k(iv, i8, qm),
           "same_rank_order": float((iv == i8).mean()),
           "dist_err": float(np.abs(dv - d8).max())}
    check(out["recall"] == 1.0 and out["dist_err"] <= DIST_TOL,
          f"full probe vs exact int8: {out}")
    return out


def phase_serve_ivf_checks(ivf, int8_rec, dev, card):
    engine, stream, tickets, centers, rng, rec = ivf
    ix = engine.index
    out = {"phase": "serve_ivf_checks", "card": card}
    r, derr = served_vs_plain(engine, stream, tickets, dev)
    out.update(recall_vs_plain=r, dist_err_vs_plain=derr)
    check(r >= MIN_RECALL and derr <= SERVE_DIST_TOL,
          f"ivf: served vs plain engine recall {r}, dist err {derr}")

    qp, _ = query_set(rng, centers, N_HOST)
    qm = np.ones((C, N_HOST), np.float32)
    ids_d, d_d = engine.query_batch(qp, qm)
    ids_h, d_h = query_ivf_host(engine.theta, ix.bn_mu, ix.bn_sd, qp, qm,
                                ix.cent, ix.cn2, ix.bq, ix.pack, k=K,
                                nprobe=engine.nprobe)
    r, derr = recall_at_k(ids_d, ids_h, qm), float(np.abs(d_d - d_h).max())
    out.update(recall_vs_host=r, dist_err_vs_host=derr)
    check(r >= MIN_RECALL and derr <= SERVE_DIST_TOL,
          f"ivf vs numpy host oracle: recall {r}, dist err {derr}")

    # fidelity: recall@10 against the exact int8 path on the same index
    qp, _ = query_set(rng, centers, N_RECALL)
    qm = np.ones((C, N_RECALL), np.float32)
    eng8 = RetrievalEngine(ix, engine.theta, k=K, mode="int8", refresh=False)
    i8, _ = eng8.query_batch(qp, qm)
    out["recall_at_10_vs_int8"] = {
        str(p): recall_at_k(RetrievalEngine(
            ix, engine.theta, k=K, mode="ivf", nprobe=p,
            refresh=False).query_batch(qp, qm)[0], i8, qm)
        for p in NPROBE_SWEEP}
    out["qps_ratio_to_serve_int8"] = rec["qps"] / int8_rec["qps"]
    check(out["recall_at_10_vs_int8"][str(NPROBE)] >= IVF_MIN_RECALL,
          f"ivf recall@10 vs exact int8 at nprobe {NPROBE}: "
          f"{out['recall_at_10_vs_int8']} < {IVF_MIN_RECALL}")

    qpt = torch.from_numpy(qp[:, :BATCH]).to(dev)
    _, _, mets = query_ivf(engine.theta, ix.bn_mu, ix.bn_sd, qpt,
                           torch.ones(qpt.shape[:2], device=dev), ix.cent,
                           ix.cn2, ix.bq, ix.pack, k=K, nprobe=engine.nprobe,
                           with_metrics=True)
    out["ivf_metrics"] = {"queries_per_client": qpt.shape[1],
                          "rows_scored": mets["rows_scored"].tolist(),
                          "probe_hits": mets["probe_hits"].tolist()}

    # the refresh is deterministic: one head, two refreshes, equal bits
    refresh_ms = []
    bits = []
    for _ in range(2):
        t0 = time.perf_counter()
        engine.update(engine.theta)
        torch.cuda.synchronize()
        refresh_ms.append((time.perf_counter() - t0) * 1e3)
        bits.append({n: b.clone() for n, b in image_bits(ix).items()})
    same = {n: bool(torch.equal(bits[0][n], bits[1][n])) for n in bits[0]}
    out.update(refresh_ms_repeat=refresh_ms, refresh_bit_identical=same)
    check(all(same.values()), f"two refreshes under one head differ: {same}")
    out["full_probe"] = full_probe_vs_int8(dev)
    emit(out)


# ---------------------------------------------------------------------------
# phase 8: the federated round
# ---------------------------------------------------------------------------


class RecordingFedSTIL(FedSTIL):
    """FedSTIL that keeps round 0's normalized relevance and (stacked
    engine) its dispatched bases (flattened) for the card-vs-CPU
    comparison, the heads of its last evaluation, and (host engine) the
    number of server rounds that aggregated any rows."""

    round0 = None
    last_eval_theta = None
    aggregated_rounds = 0

    def server_round(self, rnd, uploads):
        dispatches = super().server_round(rnd, uploads)
        self.aggregated_rounds += any(dispatches.values())
        if rnd == 0:
            self.round0 = (self.last_W.copy(), None)
        return dispatches

    def eval_theta_stacked(self, stacked):
        self.last_eval_theta = super().eval_theta_stacked(stacked)
        return self.last_eval_theta

    def server_round_stacked(self, rnd, upload, valid=None):
        dispatch = super().server_round_stacked(rnd, upload, valid=valid)
        if rnd == 0:
            self.round0 = (self.last_W.copy(),
                           flatten_stacked(dispatch["B"])[0].cpu().numpy())
        return dispatch


ROUND_KERNELS = ("kl_similarity", "fused_relevance_aggregate",
                 "batched_pairwise_dist", "adaptive_combine")
HOST_KERNELS = ("kl_similarity", "relevance_aggregate",
                "batched_pairwise_dist", "adaptive_combine")
# operands the round never writes in place (each step makes new heads), kept
# by reference so the round's stage times carry no copies
BY_REFERENCE = ("adaptive_combine",)
# the ``ops`` entry a path reaches a kernel through, where its name differs
OP_OF = {"adaptive_combine": "adaptive_combine_tree"}


@contextlib.contextmanager
def last_operands(names, by_reference=BY_REFERENCE):
    """Route ``ops.<name>`` through a pass-through that keeps the last
    call's operands: yields {name: operands}, so each kernel can be held
    against its plain version at the shapes and values the path gave it.
    Names in ``by_reference`` keep references, for operands the path never
    writes in place (the IVF image is replaced at refresh, not
    overwritten), so the path's timing carries no copies."""
    seen, orig = {}, {n: getattr(ops, OP_OF.get(n, n)) for n in names}

    def keep(name):
        def call(*args, **kw):
            # a tree's dicts are copied (its leaves are not), so a caller
            # that rebinds a key later leaves the kept call intact
            seen[name] = tuple(tree_map(lambda t: t, a)
                               if name in by_reference
                               else a.detach().clone() for a in args)
            return orig[name](*args, **kw)
        return call

    with patched_ops({OP_OF.get(n, n): keep(n) for n in names}):
        yield seen


def path_work(name, args):
    """(bytes, operations) of a round kernel's call on ``args``, counted as
    in phase 3's rows."""
    if name == "batched_pairwise_dist":
        (c, q, f), g = args[0].shape, args[1].shape[1]
        return dist_work(name, c, q, g, f)
    if name == "kl_similarity":
        return kl_work(args[0].shape[0], args[1].shape[0], args[0].shape[1])
    if name == "normalize_relevance":
        return normalize_work(args[0].shape[0])
    if name in ("fused_relevance_aggregate", "relevance_aggregate"):
        (r, c), p = args[0].shape, args[1].shape[1]
        return aggregate_work(r, c, p, name == "fused_relevance_aggregate")
    if name == "adaptive_combine":
        return combine_work(args[0])
    c, p = args[0].shape
    if name == "batched_quantize":
        return quantize_work(c, p, 256)
    return 5.0 * c * p + 4.0 * args[1].numel(), 1.0 * c * p   # dequantize


def path_operand_errs(seen):
    """Each round kernel against its plain version on the operands of its
    last call in the card run (the last eval's (C, T Q, F) x (C, G_max, F)
    distances, the last server round's relevance and aggregate, the last
    combine's tree), and timed there beside its bound: the paths' own
    shapes, which the launches x (ms - bound) ordering of PERF.md reads."""
    checks = {
        "batched_pairwise_dist": lambda *a: max(dist_err(
            "batched_pairwise_dist (round)", batched_pairwise_dist,
            REF.batched_pairwise_dist_ref, *a),
            dist_variant_errs("batched_pairwise_dist", *a)[0]),
        "kl_similarity": kl_err,
        "fused_relevance_aggregate": aggregate_err,
        "normalize_relevance": normalize_err,
        "relevance_aggregate": plain_aggregate_err,
        "adaptive_combine": combine_tree_err,
        "batched_quantize": lambda x: quantize_err(x, 256),
        "batched_dequantize": lambda q, sc: dequantize_err(q, sc, 256)}
    plain = {"batched_pairwise_dist": REF.batched_pairwise_dist_ref,
             "kl_similarity": REF.kl_similarity_ref,
             "fused_relevance_aggregate": REF.fused_relevance_aggregate_ref,
             "normalize_relevance": REF.normalized_relevance_ref,
             "relevance_aggregate": REF.relevance_aggregate_ref,
             "adaptive_combine": REF.adaptive_combine_tree_ref,
             "batched_quantize": REF.batched_quantize_ref,
             "batched_dequantize": REF.batched_dequantize_ref}
    peak = peaks(torch.cuda.get_device_name(0))
    out = {}
    for n in (n for n in checks if n in seen):
        args = seen[n]
        if n == "adaptive_combine":            # (B, alpha, A) trees -> leaves
            args = tuple([t.detach().contiguous() for t in tree_leaves(tr)]
                         for tr in args)
        kw = {"chunk": 256} if "quantize" in n else {}
        b = bound(*path_work(n, args), peak)
        out[n] = {"shapes": [list(a.shape) for a in args[0]]
                  if n == "adaptive_combine"
                  else [list(a.shape) for a in args],
                  "max_abs_err": checks[n](*args),
                  "ms": time_ms(lambda: KERNELS[n]["fn"](*args, **kw)),
                  "plain_ms": time_ms(lambda: plain[n](*args, **kw)),
                  "bound_ms": b[0], "bound_by": b[1]}
        if n == "adaptive_combine":
            out[n]["library_ms"] = time_ms(
                lambda: torch._foreach_addcmul(args[2], args[0], args[1]))
            out[n]["library"] = "torch._foreach_addcmul(As, Bs, alphas)"
    return out


def simulate(bench, device, codec=None, init_params=None, engine="stacked",
             eval_backend="device", strategy=None, rounds=None):
    """One traced run of the protocol (FedSTIL by default, ROUNDS rounds)
    from SEED's weights, so its ``stage_ms`` is filled; returns (strategy,
    result, wall seconds)."""
    if strategy is None:
        strategy = RecordingFedSTIL(
            EM.EdgeModelConfig(n_classes=bench.n_classes),
            n_clients=N_CLIENTS, codec=codec)
    t0 = time.perf_counter()
    res = run_simulation(strategy, bench, rounds=rounds or ROUNDS, seed=SEED,
                         engine=engine, eval_backend=eval_backend,
                         device=device, init_params=init_params,
                         trace=obs.Tracer())
    return strategy, res, time.perf_counter() - t0


def combine_launches(strat, rounds, n_eval, clients):
    """adaptive_combine launches a FedSTIL run makes: one for each
    combine (the head is one fp32 group) — the loss's and the tying term's
    heads every step, the head after training every round, the eval heads
    every evaluation — times the clients on the host engine, once for all
    on the stacked one."""
    per_round = (2 * strat.epochs + 1) * clients
    return rounds * per_round + n_eval * clients


def nudged_init(bench):
    """The initial weights ``run_simulation`` draws from SEED (a CPU torch
    generator: the trunk, then one head per client), with the first weight
    of client 0's first layer moved up by one ulp."""
    cfg = EM.EdgeModelConfig(n_classes=bench.n_classes)
    gen = torch.Generator().manual_seed(SEED)
    to_np = lambda tree: {k: v.numpy().copy() for k, v in tree.items()}
    init = {"extraction": to_np(EM.init_extraction(cfg, gen)),
            "theta0": [to_np(EM.init_adaptive_layers(cfg, gen))
                       for _ in range(N_CLIENTS)]}
    w = init["theta0"][0]["l1.w"]
    w.flat[0] = np.nextafter(w.flat[0], np.float32(np.inf))
    return init


def summarize(values):
    v = np.asarray(values, np.float64)
    return {"median": float(np.median(v)), "max": float(v.max()),
            "total": float(v.sum()), "round0": float(v[0])}


def phase_round_fedstil(dev, card):
    """The main path of the training slice, on the card and on the CPU.
    Returns each kernel's launches during the card run and its error
    against its plain version on the operands the run gave it."""
    bench = FederatedReIDBenchmark(seed=SEED)
    zero_counts()
    with last_operands(ROUND_KERNELS) as seen:
        strat, res, wall_s = simulate(bench, dev)
    launches = counts()
    on_path = path_operand_errs(seen)
    strat_cpu, res_cpu, cpu_s = simulate(bench, "cpu")

    keys = ("mAP", "R1", "R5", "forgetting_mAP")
    n_eval = len(res.rounds)
    check(n_eval == ROUNDS // 2 and len(res_cpu.rounds) == n_eval,
          f"round_fedstil: {n_eval} eval rounds")
    for r in res.rounds:
        check(all(np.isfinite(r[k]) and 0.0 <= r[k] <= 1.0 for k in keys),
              f"round_fedstil: bad metrics in round {r['round']}: {r}")
    deltas = {k: max(abs(a[k] - b[k]) for a, b in zip(res.rounds,
                                                     res_cpu.rounds))
              for k in keys}
    final = {k: abs(res.rounds[-1][k] - res_cpu.rounds[-1][k])
             for k in ("mAP", "R1")}
    w_err = float(np.abs(strat.round0[0] - strat_cpu.round0[0]).max())
    b_err = float(np.abs(strat.round0[1] - strat_cpu.round0[1]).max())
    stages = sorted({k for s in res.stage_ms for k in s} - {"round"})
    ROUND_OUT.parent.mkdir(parents=True, exist_ok=True)
    ROUND_OUT.write_text(json.dumps({
        "card": card, "rounds": res.rounds, "rounds_cpu": res_cpu.rounds,
        "stage_ms": res.stage_ms, "stage_ms_cpu": res_cpu.stage_ms}))
    emit({"phase": "round_fedstil", "card": card, "clients": N_CLIENTS,
          "tasks": bench.n_tasks, "rounds": ROUNDS, "epochs": strat.epochs,
          "batch": strat.batch, "params_per_client": int(
              strat.round0[1].shape[1]),
          "eval_rounds": [r["round"] for r in res.rounds],
          **{k: [r[k] for r in res.rounds] for k in keys},
          "c2s_bytes": res.comm.total_c2s, "s2c_bytes": res.comm.total_s2c,
          "storage_bytes": res.storage_bytes,
          "round_wall_ms": [s["wall_ms"] for s in res.stage_ms],
          "stage_ms": {k: summarize([s.get(k, 0.0) for s in res.stage_ms])
                       for k in stages},
          "sim_wall_s": wall_s, "cpu_sim_wall_s": cpu_s,
          "cpu_final": {k: res_cpu.rounds[-1][k] for k in keys},
          "card_vs_cpu": {"round0_W_err": w_err, "round0_B_err": b_err,
                          "final_abs_delta": final,
                          "largest_per_round_delta": deltas},
          "launches": {k: launches[k] for k in ROUND_KERNELS},
          "kernel_vs_plain_on_path": on_path,
          "detail": str(ROUND_OUT.relative_to(ROOT))})
    emit({"phase": "round_fedstil_stages", "card": card,
          "stage_ms_per_round": {k: [s.get(k, 0.0) for s in res.stage_ms]
                                 for k in ("gather", "local_train", "server",
                                           "apply", "eval")}})
    check(w_err <= ROUND_W_TOL and b_err <= ROUND_B_TOL,
          f"round 0 card vs CPU: W err {w_err} (<= {ROUND_W_TOL}), B err "
          f"{b_err} (<= {ROUND_B_TOL})")
    check(all(v <= ROUND_METRIC_TOL for v in final.values()),
          f"final round card vs CPU: {final} > {ROUND_METRIC_TOL}")
    check(res.comm.total_c2s == res_cpu.comm.total_c2s
          and res.comm.total_s2c == res_cpu.comm.total_s2c
          and res.storage_bytes == res_cpu.storage_bytes,
          "round_fedstil: card and CPU byte accounting differ")
    expect = {"kl_similarity": ROUNDS, "fused_relevance_aggregate": ROUNDS,
              "batched_pairwise_dist": n_eval,
              "adaptive_combine": combine_launches(strat, ROUNDS, n_eval,
                                                   1)}
    check(all(launches[k] == n for k, n in expect.items()),
          f"round_fedstil launches {launches}, expected {expect}")
    check(int(strat.round0[1].shape[1]) == P_ROUND,
          f"round_fedstil: P = {strat.round0[1].shape[1]} != {P_ROUND}")
    return (launches, {n: r["max_abs_err"] for n, r in on_path.items()},
            (strat, res))


def phase_serve_round_heads(strat, res, dev, card):
    """The heads the round trained serve its evaluation galleries on the
    card: ``RetrievalEngine.from_eval_cache`` at the last task, int8, 64 of
    each client's last-task queries, against the plain-version engine."""
    cache = res.eval_cache
    Cn, t = cache.bench.n_clients, cache.bench.n_tasks - 1
    engine = RetrievalEngine.from_eval_cache(strat.last_eval_theta, cache, t,
                                             k=K, mode="int8", device=dev)
    qp = np.stack([cache.protos[(c, t)][2][:N_ROUND_SERVE]
                   for c in range(Cn)]).astype(np.float32)
    qids = np.stack([cache.protos[(c, t)][3][:N_ROUND_SERVE]
                     for c in range(Cn)])
    qm = np.ones(qp.shape[:2], np.float32)
    ids, d = engine.query_batch(qp, qm)
    check(ids.shape == (Cn, N_ROUND_SERVE, K) and bool((ids >= 0).all())
          and bool(np.isfinite(d).all()), "serve_round_heads: bad answers")
    ids_p, d_p = plain_query(engine, torch.from_numpy(qp).to(dev),
                             torch.from_numpy(qm).to(dev))
    r, derr = recall_at_k(ids, ids_p, qm), float(np.abs(d - d_p).max())
    emit({"phase": "serve_round_heads", "card": card, "clients": Cn,
          "task": t, "gallery": engine.index.capacity,
          "gallery_fill": engine.index.fill,
          "queries_per_client": N_ROUND_SERVE,
          "recall_vs_plain": r, "dist_err_vs_plain": derr,
          "rank1": float((ids[..., 0] == qids).mean())})
    check(r >= MIN_RECALL and derr <= SERVE_DIST_TOL,
          f"serve_round_heads: vs plain engine recall {r}, dist err {derr}")


def phase_round_profile(dev, card, n_rounds=6):
    """Where the round's device time goes: ``n_rounds`` rounds (with their
    evaluations) of the same simulation under torch.profiler, on a warm
    card. The profiler's host-side recording slows the host, so the idle
    share is an upper bound on the unprofiled run's."""
    bench = FederatedReIDBenchmark(seed=SEED)
    strategy = FedSTIL(EM.EdgeModelConfig(n_classes=bench.n_classes),
                       n_clients=N_CLIENTS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_simulation(strategy, bench, rounds=n_rounds, seed=SEED,
                             engine="stacked", device=dev,
                             trace=obs.Tracer())
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "round_profile", "card": card, "rounds": n_rounds,
          "window_ms": window_ms,
          "rounds_wall_ms": sum(s["wall_ms"] for s in res.stage_ms),
          "device_events": len(on_card),
          "device_events_per_round": len(on_card) / n_rounds,
          "device_busy_ms": busy_ms if on_card else None,
          "device_idle_share": (1.0 - busy_ms / window_ms) if on_card
          else None,
          "top_device_ms": [[name[:60], us / 1e3] for name, us in top]})


def codec_path_errs(seen, prog):
    """The codec's encode and decode against their plain versions on the
    operands of their last call in the card run (the last round's S2C
    roundtrip), with the program's budget, and timed there beside their
    bounds and beside the launches each replaces: the path shapes rule 2's
    launches x (ms - bound) reads. Under topk+int8 the decode is the int8
    decode (dequantize + bit-unpack + unpack), held bit for bit against
    dequantize then decode too."""
    g, kg, k, p = prog.group, prog.kg, prog.k, prog.p
    int8 = prog.quant == "int8"
    dec = INT8_DECODE if int8 else "batched_topk_decode"
    (x,), dec_args = seen["batched_topk_encode"], seen[dec]
    packed = dec_args[-1]
    vals = (REF.batched_dequantize_ref(*dec_args[:2], chunk=prog.chunk)
            .contiguous() if int8 else dec_args[0])
    idx = REF.batched_idx_bitunpack_ref(packed, k=k, group=g, kg=kg)
    kw = dict(k=k, p=p, group=g, kg=kg)
    if int8:
        q, sc = dec_args[:2]
        decode = (lambda: batched_topk_decode_int8(q, sc, packed,
                                                   chunk=prog.chunk, **kw))
        plain = REF.batched_topk_decode_int8_ref(q, sc, packed,
                                                 chunk=prog.chunk, **kw)
        two = (lambda: batched_topk_decode(batched_dequantize(
            q, sc, chunk=prog.chunk), packed, **kw))
        parts = ("batched_dequantize", "batched_idx_bitunpack",
                 "batched_topk_unpack")
    else:
        decode = lambda: batched_topk_decode(vals, packed, **kw)
        plain = REF.batched_topk_decode_ref(vals, packed, **kw)
        two = (lambda: batched_topk_unpack(vals, batched_idx_bitunpack(
            packed, k=k, group=g, kg=kg), p=p, group=g, kg=kg))
        parts = ("batched_idx_bitunpack", "batched_topk_unpack")
    calls = {
        "batched_topk_encode": (
            lambda: batched_topk_encode(x, group=g, kg=kg),
            lambda: batched_idx_bitpack(batched_topk_pack(
                x, group=g, kg=kg)[1], group=g, kg=kg)),
        dec: (decode, two)}
    one = {"batched_topk_pack": lambda: batched_topk_pack(x, group=g, kg=kg),
           "batched_idx_bitpack": lambda: batched_idx_bitpack(
               idx, group=g, kg=kg),
           "batched_idx_bitunpack": lambda: batched_idx_bitunpack(
               packed, k=k, group=g, kg=kg),
           "batched_topk_unpack": lambda: batched_topk_unpack(
               vals, idx, p=p, group=g, kg=kg)}
    one_plain = {
        "batched_topk_pack": lambda: REF.batched_topk_pack_ref(
            x, group=g, kg=kg),
        "batched_idx_bitpack": lambda: REF.batched_idx_bitpack_ref(
            idx, group=g, kg=kg),
        "batched_idx_bitunpack": lambda: REF.batched_idx_bitunpack_ref(
            packed, k=k, group=g, kg=kg),
        "batched_topk_unpack": lambda: REF.batched_topk_unpack_ref(
            vals, idx, p=p, group=g, kg=kg)}
    if int8:
        one["batched_dequantize"] = lambda: batched_dequantize(
            q, sc, chunk=prog.chunk)
        one_plain["batched_dequantize"] = lambda: REF.batched_dequantize_ref(
            q, sc, chunk=prog.chunk)
    peak = peaks(torch.cuda.get_device_name(0))
    got = decode()
    pairs = {
        "batched_topk_encode": (
            batched_topk_encode(x, group=g, kg=kg),
            REF.batched_topk_encode_ref(x, group=g, kg=kg)),
        dec: ((got,), (plain,))}
    torch.cuda.synchronize()
    if int8:
        check(torch.equal(got.view(torch.int32), two().view(torch.int32)),
              f"{dec} (codec path): differs from dequantize + decode on its "
              "last operands")
    out = {}
    for name, (k_out, r_out) in pairs.items():
        check(all(exact(a, b) for a, b in zip(k_out, r_out)),
              f"{name} (codec path): differs from the plain version on its "
              "last operands")
        bd = bound(*codec_work(name, x.shape[0], p, g, kg, prog.chunk or 256),
                   peak)
        kernel, two_fn = calls[name]
        out[name] = {"shapes": [list(a.shape) for a in seen[name]],
                     "max_abs_err": max(exact_err(a.float(), b.float())
                                        for a, b in zip(k_out, r_out)),
                     "ms": time_ms(kernel), "bound_ms": bd[0],
                     "bound_by": bd[1], "two_launches_ms": time_ms(two_fn),
                     "per_thread": TP._plan(x.shape[0], p, g, kg,
                                            aligned(x)).per}
    def one_bound(n):
        work = (path_work(n, (q, sc)) if n == "batched_dequantize"
                else codec_work(n, x.shape[0], p, g, kg))
        return bound(*work, peak)[0]

    # rows 2a and 12a-15a: off the path now
    for name, names in (("batched_topk_encode", ("batched_topk_pack",
                                                 "batched_idx_bitpack")),
                        (dec, parts)):
        out[name]["one_stage"] = {
            n: {"ms": time_ms(one[n]), "plain_ms": time_ms(one_plain[n]),
                "bound_ms": one_bound(n)}
            for n in names}
    return out


def phase_round_fedstil_codec(dev, card, uncoded):
    """The round with the ``delta+topk`` wire codec on both directions, on
    the card and on the CPU: the same protocol as round_fedstil. Returns
    each kernel's launches during the card run and the codec kernels'
    errors against their plain versions on their last on-path operands."""
    bench = FederatedReIDBenchmark(seed=SEED)
    zero_counts()
    with last_operands(ROUND_KERNELS + CODEC_KERNELS) as seen:
        strat, res, wall_s = simulate(bench, dev, CODEC)
    launches = counts()
    on_path = path_operand_errs(seen)
    on_path.update(codec_path_errs(
        seen, BatchedCodec(make_codec(CODEC), P_ROUND)))
    strat_cpu, res_cpu, cpu_s = simulate(bench, "cpu", CODEC)
    _, res_nudged, _ = simulate(bench, dev, CODEC, nudged_init(bench))

    keys = ("mAP", "R1", "R5", "forgetting_mAP")
    n_eval = len(res.rounds)
    check(n_eval == ROUNDS // 2 and len(res_cpu.rounds) == n_eval,
          f"round_fedstil_codec: {n_eval} eval rounds")
    for r in res.rounds:
        check(all(np.isfinite(r[k]) and 0.0 <= r[k] <= 1.0 for k in keys),
              f"round_fedstil_codec: bad metrics in round {r['round']}: {r}")
    final = {k: abs(res.rounds[-1][k] - res_cpu.rounds[-1][k])
             for k in ("mAP", "R1")}
    deltas = {k: max(abs(a[k] - b[k]) for a, b in zip(res.rounds,
                                                     res_cpu.rounds))
              for k in ("mAP", "R1")}
    nudge = {k: abs(res.rounds[-1][k] - res_nudged.rounds[-1][k])
             for k in ("mAP", "R1")}
    rows, rows_cpu = res.comm_breakdown(), res_cpu.comm_breakdown()
    # every direction's first payload is a dense keyframe, every later one
    # a sparse residual: one launch of each kernel per residual payload
    n_c2s = sum(r["c2s_wire"] > 0 for r in rows)
    n_s2c = sum(r["s2c_wire"] > 0 for r in rows)
    expect = {n: (n_c2s - 1) + (n_s2c - 1) for n in CODEC_KERNELS}
    expect.update(dict.fromkeys(ONE_STAGE_CODEC + (INT8_DECODE,), 0))
    expect.update({"kl_similarity": ROUNDS,
                   "fused_relevance_aggregate": ROUNDS,
                   "batched_pairwise_dist": n_eval,
                   "adaptive_combine": combine_launches(
                       strat, ROUNDS, n_eval, 1)})
    totals = {"c2s_wire": res.comm.total_c2s, "s2c_wire": res.comm.total_s2c,
              "c2s_formula": res.comm.total_c2s_formula,
              "s2c_formula": res.comm.total_s2c_formula}
    stages = ("encode_c2s", "encode_s2c")
    CODEC_OUT.parent.mkdir(parents=True, exist_ok=True)
    CODEC_OUT.write_text(json.dumps({
        "card": card, "codec": CODEC, "rounds": res.rounds,
        "rounds_cpu": res_cpu.rounds, "comm_rows": rows,
        "stage_ms": res.stage_ms, "stage_ms_cpu": res_cpu.stage_ms}))
    emit({"phase": "round_fedstil_codec", "card": card, "codec": CODEC,
          "clients": N_CLIENTS, "tasks": bench.n_tasks, "rounds": ROUNDS,
          "epochs": strat.epochs, "batch": strat.batch,
          "group": GROUP, "kg": KG,
          "eval_rounds": [r["round"] for r in res.rounds],
          **{k: [r[k] for r in res.rounds] for k in keys},
          "comm_totals": totals,
          "wire_over_formula": res.comm.total / res.comm.total_formula,
          "round0_bytes": rows[0], "round1_bytes": rows[1],
          "measured_reduction_vs_uncoded": 1.0 - (res.comm.total
                                                  / uncoded.comm.total),
          "uncoded_total_bytes": uncoded.comm.total,
          "final_mAP_minus_uncoded": res.final("mAP") - uncoded.final("mAP"),
          "final_R1_minus_uncoded": res.final("R1") - uncoded.final("R1"),
          "round_wall_ms": summarize([s["wall_ms"] for s in res.stage_ms]),
          "stage_ms": {k: summarize([s.get(k, 0.0) for s in res.stage_ms])
                       for k in stages},
          "sim_wall_s": wall_s, "cpu_sim_wall_s": cpu_s,
          "cpu_final": {k: res_cpu.rounds[-1][k] for k in keys},
          "card_vs_cpu": {"final_abs_delta": final,
                          "largest_per_round_delta": deltas,
                          "tolerance": CODEC_METRIC_TOL,
                          "comm_rows_equal": rows == rows_cpu},
          "one_ulp_sensitivity": nudge,
          "launches": {k: launches[k] for k in expect},
          "expected_launches": expect,
          "kernel_vs_plain_on_path": on_path,
          "detail": str(CODEC_OUT.relative_to(ROOT))})
    check(res.comm.measured and res_cpu.comm.measured,
          "round_fedstil_codec: no measured wire bytes")
    check(rows == rows_cpu, "round_fedstil_codec: card and CPU wire bytes "
          "differ")
    check(all(r["c2s_wire"] <= r["c2s_formula"] for r in rows)
          and res.comm.total < res.comm.total_formula,
          "round_fedstil_codec: the wire is not below the formula")
    check(all(v <= CODEC_METRIC_TOL for v in final.values()),
          f"round_fedstil_codec final round card vs CPU: {final} > "
          f"{CODEC_METRIC_TOL}")
    check(all(launches[k] == n for k, n in expect.items()),
          f"round_fedstil_codec launches {launches}, expected {expect}")
    return launches, {n: r["max_abs_err"] for n, r in on_path.items()}


def metric_deltas(a_rounds, b_rounds, keys=("mAP", "R1")):
    """(largest per-eval-round |delta|, final |delta|) of each key."""
    check([r["round"] for r in a_rounds] == [r["round"] for r in b_rounds],
          "eval rounds differ")
    return ({k: max(abs(a[k] - b[k]) for a, b in zip(a_rounds, b_rounds))
             for k in keys},
            {k: abs(a_rounds[-1][k] - b_rounds[-1][k]) for k in keys})


def phase_round_fedstil_host(dev, card, stacked):
    """round_fedstil's protocol on the host engine, on the card, from the
    same initial weights: against the stacked card run (metrics, bytes,
    round 0's W), its kernels' launches and each kernel against its plain
    version on its last on-path operands."""
    strat_s, res_s = stacked
    bench = FederatedReIDBenchmark(seed=SEED)
    zero_counts()
    with last_operands(HOST_KERNELS) as seen:
        strat, res, wall_s = simulate(bench, dev, engine="host")
    launches = counts()
    on_path = path_operand_errs(seen)
    n_eval = len(res.rounds)
    per_round, final = metric_deltas(res.rounds, res_s.rounds)
    w_err = float(np.abs(strat.round0[0] - strat_s.round0[0]).max())
    expect = {"kl_similarity": ROUNDS, "batched_pairwise_dist": n_eval,
              "relevance_aggregate": strat.aggregated_rounds,
              "adaptive_combine": combine_launches(strat, ROUNDS, n_eval,
                                                   N_CLIENTS)}
    stages = sorted({k for st in res.stage_ms for k in st} - {"round"})
    HOST_OUT.parent.mkdir(parents=True, exist_ok=True)
    HOST_OUT.write_text(json.dumps({
        "card": card, "rounds": res.rounds, "rounds_stacked": res_s.rounds,
        "stage_ms": res.stage_ms}))
    keys = ("mAP", "R1", "R5", "forgetting_mAP")
    emit({"phase": "round_fedstil_host", "card": card, "engine": "host",
          "clients": N_CLIENTS, "rounds": ROUNDS, "epochs": strat.epochs,
          "eval_rounds": [r["round"] for r in res.rounds],
          **{k: [r[k] for r in res.rounds] for k in keys},
          "vs_stacked_card": {"largest_per_round_delta": per_round,
                              "final_abs_delta": final,
                              "round0_W_err": w_err,
                              "tolerance": ROUND_METRIC_TOL},
          "c2s_bytes": res.comm.total_c2s, "s2c_bytes": res.comm.total_s2c,
          "storage_bytes": res.storage_bytes,
          "aggregated_rounds": strat.aggregated_rounds,
          "round_wall_ms": summarize([st["wall_ms"] for st in res.stage_ms]),
          "stage_ms": {k: summarize([st.get(k, 0.0) for st in res.stage_ms])
                       for k in stages},
          "sim_wall_s": wall_s,
          "launches": {k: launches[k] for k in expect},
          "expected_launches": expect,
          "kernel_vs_plain_on_path": on_path,
          "detail": str(HOST_OUT.relative_to(ROOT))})
    check(all(v <= ROUND_METRIC_TOL for d in (per_round, final)
              for v in d.values()),
          f"round_fedstil_host vs stacked: per round {per_round}, final "
          f"{final} > {ROUND_METRIC_TOL}")
    check(w_err <= ROUND_W_TOL, f"round_fedstil_host round 0 W err {w_err} "
          f"> {ROUND_W_TOL}")
    check(res.comm.total_c2s == res_s.comm.total_c2s
          and res.comm.total_s2c == res_s.comm.total_s2c
          and res.storage_bytes == res_s.storage_bytes,
          "round_fedstil_host: bytes differ from the stacked run")
    check(all(launches[k] == n for k, n in expect.items()),
          f"round_fedstil_host launches {launches}, expected {expect}")
    return launches, {n: r["max_abs_err"] for n, r in on_path.items()}


def phase_round_host_variants(dev, card):
    """The slice's other paths, four rounds each on the card: FedSTIL host
    with host evaluation against device evaluation (one training, two
    evaluations: features and rankings only), STL and FedAvg host against
    stacked, the host engine with the numpy topk+int8 codec against the
    same run on the CPU, and the stacked round under the other quantized
    codecs against the CPU. Equal bytes; metrics within ROUND_METRIC_TOL
    (same training) or CODEC_METRIC_TOL (card vs CPU through a codec)."""
    bench = FederatedReIDBenchmark(seed=SEED)
    cfg = EM.EdgeModelConfig(n_classes=bench.n_classes)
    out = {}

    def pair(name, a, b, tol, same_bytes=True):
        (_, ra, _), (_, rb, _) = a, b
        per_round, final = metric_deltas(ra.rounds, rb.rounds)
        rows_equal = ra.comm_breakdown() == rb.comm_breakdown()
        out[name] = {"largest_per_round_delta": per_round,
                     "final_abs_delta": final, "tolerance": tol,
                     "bytes_equal": rows_equal, "final_mAP": ra.final("mAP"),
                     "wire_bytes": ra.comm.total,
                     "formula_bytes": ra.comm.total_formula}
        check(all(v <= tol for v in per_round.values()),
              f"round_host_variants {name}: {per_round} > {tol}")
        check(rows_equal or not same_bytes,
              f"round_host_variants {name}: bytes differ")

    def run(device, make, **kw):
        return simulate(bench, device, strategy=make(), rounds=VARIANT_ROUNDS,
                        **kw)

    fedstil = lambda **kw: (lambda: FedSTIL(cfg, n_clients=N_CLIENTS, **kw))
    pair("fedstil_host_eval_vs_device_eval",
         run(dev, fedstil(), engine="host", eval_backend="host"),
         run(dev, fedstil(), engine="host"), ROUND_METRIC_TOL)
    for name, make in (("stl", lambda: STL(cfg)),
                       ("fedavg", lambda: FedAvg(cfg))):
        pair(f"{name}_host_vs_stacked", run(dev, make, engine="host"),
             run(dev, make, engine="stacked"), ROUND_METRIC_TOL)
    pair("fedstil_host_topk+int8_card_vs_cpu",
         run(dev, fedstil(codec=CODEC_INT8), engine="host"),
         run("cpu", fedstil(codec=CODEC_INT8), engine="host"),
         CODEC_METRIC_TOL)
    for codec in ("int8", "bf16", "delta+topk+bf16"):
        pair(f"fedstil_stacked_{codec}_card_vs_cpu",
             run(dev, fedstil(codec=codec), engine="stacked"),
             run("cpu", fedstil(codec=codec), engine="stacked"),
             CODEC_METRIC_TOL)
    pair("fedavg_stacked_int8_card_vs_cpu",
         run(dev, lambda: FedAvg(cfg, codec="int8"), engine="stacked"),
         run("cpu", lambda: FedAvg(cfg, codec="int8"), engine="stacked"),
         CODEC_METRIC_TOL)
    emit({"phase": "round_host_variants", "card": card,
          "rounds": VARIANT_ROUNDS, "clients": N_CLIENTS, "runs": out})


def phase_round_fedstil_codec_int8(dev, card, uncoded):
    """round_fedstil's protocol with topk+int8 on the stacked engine, on
    the card and on the CPU: bytes, launches, card vs CPU, and the
    quantize / dequantize / codec kernels against their plain versions on
    their last on-path operands."""
    bench = FederatedReIDBenchmark(seed=SEED)
    zero_counts()
    names = (ROUND_KERNELS + ("batched_topk_encode", INT8_DECODE,
                              "batched_quantize", "batched_dequantize"))
    with last_operands(names) as seen:
        strat, res, wall_s = simulate(bench, dev, CODEC_INT8)
    launches = counts()
    on_path = path_operand_errs(seen)
    on_path.update(codec_path_errs(
        seen, BatchedCodec(make_codec(CODEC_INT8), P_ROUND)))
    _, res_short, _ = simulate(bench, dev, CODEC_INT8, rounds=INT8_CPU_ROUNDS)
    _, res_cpu, cpu_s = simulate(bench, "cpu", CODEC_INT8,
                                 rounds=INT8_CPU_ROUNDS)

    n_eval = len(res.rounds)
    per_round, final = metric_deltas(res_short.rounds, res_cpu.rounds)
    rows = res.comm_breakdown()
    rows_short, rows_cpu = res_short.comm_breakdown(), res_cpu.comm_breakdown()
    n_c2s = sum(r["c2s_wire"] > 0 for r in rows)
    n_s2c = sum(r["s2c_wire"] > 0 for r in rows)
    # a residual payload: one encode and one int8 decode (dequantize
    # folded in); the two dense keyframes: dequantize
    residuals = (n_c2s - 1) + (n_s2c - 1)
    expect = {"batched_topk_encode": residuals, INT8_DECODE: residuals,
              "batched_topk_decode": 0}
    expect.update(dict.fromkeys(ONE_STAGE_CODEC, 0))
    expect.update({"batched_quantize": n_c2s + n_s2c,
                   "batched_dequantize": 2,
                   "kl_similarity": ROUNDS,
                   "fused_relevance_aggregate": ROUNDS,
                   "batched_pairwise_dist": n_eval,
                   "adaptive_combine": combine_launches(
                       strat, ROUNDS, n_eval, 1)})
    keys = ("mAP", "R1", "R5", "forgetting_mAP")
    stages = ("encode_c2s", "encode_s2c")
    INT8_OUT.parent.mkdir(parents=True, exist_ok=True)
    INT8_OUT.write_text(json.dumps({
        "card": card, "codec": CODEC_INT8, "rounds": res.rounds,
        "rounds_cpu": res_cpu.rounds, "comm_rows": rows,
        "stage_ms": res.stage_ms, "stage_ms_cpu": res_cpu.stage_ms}))
    emit({"phase": "round_fedstil_codec_int8", "card": card,
          "codec": CODEC_INT8, "clients": N_CLIENTS, "rounds": ROUNDS,
          "eval_rounds": [r["round"] for r in res.rounds],
          **{k: [r[k] for r in res.rounds] for k in keys},
          "wire_bytes": res.comm.total, "predicted_wire_bytes":
          INT8_WIRE_BYTES, "formula_bytes": res.comm.total_formula,
          "wire_over_formula": res.comm.total / res.comm.total_formula,
          "round0_bytes": rows[0], "round1_bytes": rows[1],
          "final_mAP_minus_uncoded": res.final("mAP") - uncoded.final("mAP"),
          "final_R1_minus_uncoded": res.final("R1") - uncoded.final("R1"),
          "round_wall_ms": summarize([st["wall_ms"] for st in res.stage_ms]),
          "stage_ms": {k: summarize([st.get(k, 0.0) for st in res.stage_ms])
                       for k in stages},
          "sim_wall_s": wall_s, "cpu_sim_wall_s": cpu_s,
          "card_vs_cpu": {"rounds": INT8_CPU_ROUNDS,
                          "final_abs_delta": final,
                          "largest_per_round_delta": per_round,
                          "tolerance": CODEC_METRIC_TOL,
                          "comm_rows_equal": rows_short == rows_cpu},
          "launches": {k: launches[k] for k in expect},
          "expected_launches": expect,
          "kernel_vs_plain_on_path": on_path,
          "detail": str(INT8_OUT.relative_to(ROOT))})
    check(rows_short == rows_cpu, "round_fedstil_codec_int8: card and CPU "
          "wire bytes differ")
    check(res.comm.total == INT8_WIRE_BYTES,
          f"round_fedstil_codec_int8: {res.comm.total} wire bytes, predicted "
          f"{INT8_WIRE_BYTES}")
    check(all(v <= CODEC_METRIC_TOL for v in final.values()),
          f"round_fedstil_codec_int8 final round card vs CPU: {final} > "
          f"{CODEC_METRIC_TOL}")
    check(all(launches[k] == n for k, n in expect.items()),
          f"round_fedstil_codec_int8 launches {launches}, expected {expect}")
    return launches, {n: r["max_abs_err"] for n, r in on_path.items()}, res


# ---------------------------------------------------------------------------
# path 8: the sharded engine on a world of one
# ---------------------------------------------------------------------------


def sharded_sim(bench, dev, rounds=None, **kw):
    """One traced sharded run of the protocol from SEED's weights on a
    world of one (NCCL on the card, created and destroyed by the run)."""
    strategy = RecordingFedSTIL(EM.EdgeModelConfig(n_classes=bench.n_classes),
                                n_clients=N_CLIENTS, **kw)
    return simulate(bench, dev, engine="sharded", strategy=strategy,
                    rounds=rounds)


def sharded_server_scale(dev):
    """The sharded Eq. 5 -> 6 (``sharded_fused_aggregate``: Wn by
    normalize_relevance, row 10's kernel on Wn's one column block, one
    reduce-scatter) at the round's
    and the fleet's shapes against the one-device fused kernel (row 9):
    B within AGG_TOL, Wn within WN_TOL, whether B is bit for bit row 9's;
    device ms of both; the FedSTIL server round, sharded and stacked: its
    host wall (median of rounds past a full ring) and the peak bytes it
    allocates above what is held; and fed_round on the one-rank mesh
    against the numpy server."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = EM.EdgeModelConfig()
    out = {}
    with SH.engine_world(dev), SH.engine_mesh(device=dev) as mesh:
        for C, P in ((N_CLIENTS, P_ROUND),) + tuple(
                (c, P_EDGE) for c in SCALE_CLIENTS):
            w = torch.rand((C, C), generator=gen, device=dev)
            th = torch.randn((C, P), generator=gen, device=dev)
            B, Wn = sharded_fused_aggregate(w, th, mesh)
            Bf, Wnf = fused_relevance_aggregate(w, th)
            row = {"B_err": float((B - Bf).abs().max()),
                   "Wn_err": float((Wn - Wnf).abs().max()),
                   "B_bit_equal_row9": bool(torch.equal(B, Bf)),
                   "Wn_bit_equal_row9": bool(torch.equal(Wn, Wnf)),
                   "sharded_ms": time_ms(
                       lambda: sharded_fused_aggregate(w, th, mesh)),
                   "fused_ms": time_ms(
                       lambda: fused_relevance_aggregate(w, th))}
            check(row["B_err"] <= AGG_TOL and row["Wn_err"] <= WN_TOL,
                  f"round_sharded aggregate at C={C}: {row}")
            if P == P_EDGE:
                heads = EM.stack_heads([EM.init_adaptive_layers(cfg, gen)
                                        for _ in range(C)], dev)
                for name in ("stacked", "sharded"):
                    strat = FedSTIL(cfg, n_clients=C, history_len=HIST_K)
                    kw = ({"valid": strat.bind_mesh(mesh, C)}
                          if name == "sharded" else {})
                    walls, peaks_b = [], []
                    for rnd in range(HIST_K + 2):
                        up = {"theta": heads,
                              "task_feature": task_features(gen, dev, C)}
                        torch.cuda.synchronize()
                        held = torch.cuda.memory_allocated()
                        torch.cuda.reset_peak_memory_stats()
                        t0 = time.perf_counter()
                        strat.server_round_stacked(rnd, up, **kw)
                        torch.cuda.synchronize()
                        walls.append((time.perf_counter() - t0) * 1e3)
                        peaks_b.append(torch.cuda.max_memory_allocated()
                                       - held)
                    row[f"{name}_server_round_wall_ms"] = float(
                        np.median(walls[2:]))
                    row[f"{name}_server_round_peak_bytes"] = int(
                        max(peaks_b))
                    del strat
                del heads
            out[f"C={C},P={P}"] = row
            del w, th, B, Bf
            torch.cuda.empty_cache()
        thetas, feats, hists = FR.demo_inputs(1, 128, P_EDGE, HIST_K)
        B, w_row = FR.fed_round(
            {"w": torch.from_numpy(thetas[0]).to(dev)},
            torch.from_numpy(feats[0]).to(dev),
            torch.from_numpy(hists[0]).to(dev), mesh=mesh)
        Wref, Bref = FR.server_oracle(thetas, feats, hists)
        out["fed_round_world_1"] = {
            "B_err": float(np.abs(B["w"].cpu().numpy() - Bref[0]).max()),
            "W_err": float(np.abs(w_row.cpu().numpy() - Wref[0]).max())}
        check(out["fed_round_world_1"]["B_err"] <= AGG_TOL
              and out["fed_round_world_1"]["W_err"] <= WN_TOL,
              f"fed_round on one rank: {out['fed_round_world_1']}")
    return out


def phase_round_sharded(dev, card, stacked, res_int8, stacked_launches):
    """The sharded engine (``run_simulation(engine="sharded")``) on a world
    of one on the card (NCCL), five things: (1) round_fedstil's protocol
    with the float32 wire against round_fedstil's stacked card run (every
    eval round's mAP / R1 within SHARDED_TOL, bytes equal, round 0's Wn
    within WN_TOL, the launches: kl_similarity, batched_pairwise_dist and
    the combine as round_fedstil's, Eq. 5 -> 6 on normalize_relevance and
    relevance_aggregate (row 10) once a round each and never on the fused
    entry); (2) the default bf16 wire
    (bytes equal, final mAP / R1 within ROUND_METRIC_TOL); (3) topk+int8
    with the float32 wire against round_fedstil_codec_int8's card run
    (every round's wire and formula bytes equal, final within
    CODEC_METRIC_TOL); (4) ``sharded_server_scale``; (5) a traced sharded
    run's events against the stacked engine's. Counts are zeroed just
    before each of runs 1-3 and read just after; the path's launches are
    their sum. Returns (launches, on-path errors)."""
    strat0, res0 = stacked
    bench = FederatedReIDBenchmark(seed=SEED)
    runs, launches = {}, {}
    zero_counts()
    with last_operands(SHARDED_KERNELS) as seen:
        runs["float32"] = sharded_sim(bench, dev, wire_dtype="float32")
    launches["float32"] = counts()
    on_path = path_operand_errs(seen)
    del seen
    zero_counts()
    runs["bfloat16"] = sharded_sim(bench, dev)
    launches["bfloat16"] = counts()
    zero_counts()
    runs["topk+int8"] = sharded_sim(bench, dev, wire_dtype="float32",
                                    codec=CODEC_INT8)
    launches["topk+int8"] = counts()
    path = {k: sum(c[k] for c in launches.values()) for k in KERNELS}

    strat1, res1, wall1 = runs["float32"]
    n_eval = len(res1.rounds)
    keys = ("mAP", "R1", "R5", "forgetting_mAP")
    deltas = {name: metric_deltas(res0.rounds if name != "topk+int8"
                                  else res_int8.rounds, r.rounds, keys)
              for name, (_, r, _) in runs.items()}
    w_err = float(np.abs(strat1.round0[0] - strat0.round0[0]).max())
    same_bytes = {name: (r.comm.total_c2s, r.comm.total_s2c,
                         r.storage_bytes) == (ref.comm.total_c2s,
                                              ref.comm.total_s2c,
                                              ref.storage_bytes)
                  for name, (_, r, _), ref in zip(
                      runs, runs.values(), (res0, res0, res_int8))}
    rows_equal = runs["topk+int8"][1].comm_breakdown() == \
        res_int8.comm_breakdown()
    scale = sharded_server_scale(dev)

    # (5) a traced sharded run emits the stacked engine's events
    tr_sh, tr_st = obs.Tracer(), obs.Tracer()
    for tracer, engine in ((tr_sh, "sharded"), (tr_st, "stacked")):
        run_simulation(RecordingFedSTIL(EM.EdgeModelConfig(
            n_classes=bench.n_classes), n_clients=N_CLIENTS), bench,
            rounds=SHARDED_TRACE_ROUNDS, seed=SEED, engine=engine,
            device=dev, trace=tracer)
    event_key = lambda e: (e["kind"], e.get("name"), e.get("cat"),
                           e.get("round"), e.get("direction"))
    ev_sh = [event_key(e) for e in tr_sh.events]
    ev_st = [event_key(e) for e in tr_st.events]

    SHARDED_OUT.parent.mkdir(parents=True, exist_ok=True)
    SHARDED_OUT.write_text(json.dumps({
        "card": card, **{name: {"rounds": r.rounds,
                                "comm_rows": r.comm_breakdown(),
                                "stage_ms": r.stage_ms}
                         for name, (_, r, _) in runs.items()}}))
    shown = ("kl_similarity", "normalize_relevance", "relevance_aggregate",
             "fused_relevance_aggregate", "batched_pairwise_dist",
             "adaptive_combine", "batched_quantize", "batched_dequantize",
             "batched_topk_encode", INT8_DECODE)
    emit({"phase": "round_sharded", "card": card, "world": 1,
          "backend": SH.BACKENDS[dev.type], "clients": N_CLIENTS,
          "rounds": ROUNDS,
          "eval_rounds": [r["round"] for r in res1.rounds],
          **{f"{k}_float32": [r[k] for r in res1.rounds] for k in keys},
          "per_round_max_delta": {n: d[0] for n, d in deltas.items()},
          "final_abs_delta": {n: d[1] for n, d in deltas.items()},
          "reference": {"float32": "round_fedstil (stacked, card)",
                        "bfloat16": "round_fedstil (stacked, card)",
                        "topk+int8": "round_fedstil_codec_int8 (card)"},
          "round0_Wn_err": w_err, "bytes_equal": same_bytes,
          "int8_comm_rows_equal": rows_equal,
          "sim_wall_s": {n: r[2] for n, r in runs.items()},
          "round_wall_ms": {n: summarize([st["wall_ms"]
                                          for st in r[1].stage_ms])
                            for n, r in runs.items()},
          "server_ms": {n: summarize([st.get("server", 0.0)
                                      for st in r[1].stage_ms])
                        for n, r in runs.items()},
          "launches_per_round": {n: {k: c[k] / ROUNDS for k in shown}
                                 for n, c in launches.items()},
          "launches": {n: {k: c[k] for k in shown}
                       for n, c in launches.items()},
          "launches_round_fedstil": {k: stacked_launches[k] for k in (
              "kl_similarity", "fused_relevance_aggregate",
              "batched_pairwise_dist", "adaptive_combine")},
          "eq6_kernels": "normalize_relevance (row 9's normalize stage), "
                         "then relevance_aggregate (row 10)",
          "server_scale": scale,
          "traced": {"rounds": SHARDED_TRACE_ROUNDS,
                     "events_equal_stacked": ev_sh == ev_st,
                     "events": len(ev_sh), "spans_round0": [
                         e[1] for e in ev_sh
                         if e[0] == "span" and e[3] == 0]},
          "kernel_vs_plain_on_path": on_path,
          "detail": str(SHARDED_OUT.relative_to(ROOT))})
    f32 = launches["float32"]
    check(deltas["float32"][0]["mAP"] <= SHARDED_TOL
          and deltas["float32"][0]["R1"] <= SHARDED_TOL,
          f"round_sharded float32 wire vs stacked: {deltas['float32'][0]}")
    check(w_err <= WN_TOL, f"round_sharded round 0 Wn err {w_err}")
    check(all(same_bytes.values()) and rows_equal,
          f"round_sharded bytes differ: {same_bytes}, int8 rows "
          f"{rows_equal}")
    check(deltas["bfloat16"][1]["mAP"] <= ROUND_METRIC_TOL
          and deltas["bfloat16"][1]["R1"] <= ROUND_METRIC_TOL,
          f"round_sharded bf16 final: {deltas['bfloat16'][1]}")
    check(deltas["topk+int8"][1]["mAP"] <= CODEC_METRIC_TOL
          and deltas["topk+int8"][1]["R1"] <= CODEC_METRIC_TOL,
          f"round_sharded topk+int8 final: {deltas['topk+int8'][1]}")
    check(all(f32[k] == stacked_launches[k] for k in (
        "kl_similarity", "batched_pairwise_dist", "adaptive_combine"))
          and f32["relevance_aggregate"] == ROUNDS
          and f32["normalize_relevance"] == ROUNDS
          and f32["fused_relevance_aggregate"] == 0
          and f32["batched_pairwise_dist"] == n_eval,
          f"round_sharded launches {f32}")
    check(launches["topk+int8"]["fused_relevance_aggregate"] == 0
          and launches["topk+int8"]["relevance_aggregate"] == ROUNDS
          and launches["topk+int8"]["normalize_relevance"] == ROUNDS,
          f"round_sharded topk+int8 launches {launches['topk+int8']}")
    check(ev_sh == ev_st, "round_sharded: the traced sharded run's events "
          "differ from the stacked engine's")
    return path, {n: r["max_abs_err"] for n, r in on_path.items()}



# ---------------------------------------------------------------------------
# phase 9: the stacked server step at fleet sizes
# ---------------------------------------------------------------------------


def tie_excess(a) -> int:
    """Entries of a sparsified leaf kept beyond k = max(1, int(0.3 size)):
    the exact ties at its top-30% threshold."""
    flat = torch.abs(a).reshape(-1)
    k = max(1, int(0.3 * flat.numel()))
    return int(torch.count_nonzero(flat >= torch.sort(flat)[0][-k])) - k


class RecordingFedWeIT(FedWeIT):
    """FedWeIT that keeps every upload's nnz, its ties at the threshold
    (``tie_excess`` over its leaves) and the k its top-30% keeps before
    ties (sum over leaves of max(1, int(0.3 size)))."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.nnz, self.ties, self.k = [], [], 0

    def local_train(self, client, state, protos, labels, rnd, **kw):
        state, up = super().local_train(client, state, protos, labels, rnd,
                                        **kw)
        self.nnz.append(int(up["A_nnz"]))
        self.ties.append(sum(tie_excess(a) for a in tree_leaves(up["A"])))
        self.k = sum(max(1, int(0.3 * a.numel()))
                     for a in tree_leaves(up["A"]))
        return state, up


def zoo_strategies(cfg):
    """The Table II baselines as ``benchmarks/common.py:36-52`` builds them
    (epochs 4; FedWeIT's settings (a) and (b))."""
    weit = lambda l1, l2: lambda: RecordingFedWeIT(
        cfg, epochs=ZOO_EPOCHS, n_clients=N_CLIENTS, l1=l1, l2=l2)
    return {"ewc": lambda: EWC(cfg, epochs=ZOO_EPOCHS),
            "mas": lambda: MAS(cfg, epochs=ZOO_EPOCHS),
            "icarl": lambda: ICaRL(cfg, epochs=ZOO_EPOCHS,
                                   extractor=EM.extract_prototypes),
            "fedprox": lambda: FedProx(cfg, epochs=ZOO_EPOCHS),
            "fedcurv": lambda: FedCurv(cfg, epochs=ZOO_EPOCHS),
            "fedweit_a": weit(1e-4, 1e-6),
            "fedweit_b": weit(5e-6, 1e-3)}


def zoo_run(bench, device, make, engine="host", rounds=ZOO_ROUNDS):
    """One traced zoo run of ``rounds`` from SEED's weights -> (strategy,
    result, wall s)."""
    strategy = make()
    t0 = time.perf_counter()
    res = run_simulation(strategy, bench, rounds=rounds,
                         eval_every=ZOO_EVAL_EVERY, seed=SEED, engine=engine,
                         device=device, trace=obs.Tracer())
    return strategy, res, time.perf_counter() - t0


def zoo_bytes(name, card_run, cpu_run):
    """Card vs CPU bytes: equal, except FedWeIT's nnz, which counts exact
    ties at its top-30% threshold (tests/test_torch_fed_strategies.py: the
    kept entries of ``l2.b``, whose cross-entropy gradient BN erases, are
    chosen by rounding). Each FedWeIT upload keeps exactly k plus its own
    ties on either side, so card and CPU nnz differ by no more than their
    ties (equal where neither has any), and the raw C2S / S2C totals differ
    by exactly 8 bytes a differing entry, once up and once to each client
    down."""
    (sa, ra, _), (sb, rb, _) = card_run, cpu_run
    out = {"c2s": [ra.comm.total_c2s, rb.comm.total_c2s],
           "s2c": [ra.comm.total_s2c, rb.comm.total_s2c],
           "storage": [ra.storage_bytes, rb.storage_bytes]}
    if not name.startswith("fedweit"):
        out["equal"] = (ra.comm.round_breakdown() == rb.comm.round_breakdown()
                        and ra.storage_bytes == rb.storage_bytes)
        return out
    na, nb = sum(sa.nnz), sum(sb.nnz)
    out.update(nnz=[na, nb], ties=[sum(sa.ties), sum(sb.ties)], k=sa.k,
               uploads=len(sa.nnz),
               uploads_nnz_differ=sum(a != b for a, b in zip(sa.nnz, sb.nnz)))
    out["equal"] = (len(sa.nnz) == len(sb.nnz) == N_CLIENTS * ZOO_CPU_ROUNDS
                    and sa.k == sb.k
                    and all(n == sa.k + t for n, t in zip(sa.nnz, sa.ties))
                    and all(n == sb.k + t for n, t in zip(sb.nnz, sb.ties))
                    and all(abs(a - b) <= max(ta, tb) for a, b, ta, tb in
                            zip(sa.nnz, sb.nnz, sa.ties, sb.ties))
                    and ra.comm.total_c2s - rb.comm.total_c2s == 8 * (na - nb)
                    and ra.comm.total_s2c - rb.comm.total_s2c
                    == 8 * N_CLIENTS * (na - nb)
                    and ra.storage_bytes == rb.storage_bytes)
    return out


def phase_round_zoo(dev, card):
    """The Table II baselines on the card and on the CPU, from the same
    initial weights, on the paper's bench (C = 5, T = 6, the edge model's
    widths), ZOO_ROUNDS rounds: EWC, MAS, iCaRL, FedProx, FedCurv and
    FedWeIT (a) and (b) on the host engine, FedProx also on the stacked
    engine on the card. Card vs CPU, both at ZOO_CPU_ROUNDS: bytes
    (``zoo_bytes``), every eval round's mAP / R1 within ZOO_TOL; FedProx
    host vs stacked on the card the same, with equal bytes;
    batched_pairwise_dist once an evaluation and no other kernel, held
    against its plain version on its last on-path operands."""
    bench = FederatedReIDBenchmark(seed=SEED)
    cfg = EM.EdgeModelConfig(n_classes=bench.n_classes)
    makes = zoo_strategies(cfg)
    zero_counts()
    with last_operands(("batched_pairwise_dist",)) as seen:
        card_runs = {n: zoo_run(bench, dev, m) for n, m in makes.items()}
        stacked = zoo_run(bench, dev, makes["fedprox"], engine="stacked")
    launches = counts()
    on_path = path_operand_errs(seen)
    n_eval = len(stacked[1].rounds)
    expect = {n: 0 for n in KERNELS}
    expect["batched_pairwise_dist"] = (len(card_runs) + 1) * n_eval
    # card vs CPU at ZOO_CPU_ROUNDS (a prefix of the card path: one round a
    # task at either depth)
    short = {n: zoo_run(bench, dev, m, rounds=ZOO_CPU_ROUNDS)
             for n, m in makes.items()}
    t0 = time.perf_counter()
    cpu_runs = {n: zoo_run(bench, "cpu", m, rounds=ZOO_CPU_ROUNDS)
                for n, m in makes.items()}
    cpu_s = time.perf_counter() - t0

    keys = ("mAP", "R1", "forgetting_mAP")
    runs, tables = {}, {}
    for name, (strat, res, wall_s) in card_runs.items():
        _, res_short, _ = short[name]
        _, res_cpu, _ = cpu_runs[name]
        check(len(res.rounds) == n_eval
              and [r["round"] for r in res_short.rounds]
              == [r["round"] for r in res_cpu.rounds]
              == [r["round"] for r in res.rounds
                  if r["round"] < ZOO_CPU_ROUNDS] != [],
              f"round_zoo {name}: eval rounds {len(res.rounds)}, card "
              f"{res_short.rounds} vs CPU {res_cpu.rounds}")
        for r in res.rounds:
            check(all(np.isfinite(r[k]) and 0.0 <= r[k] <= 1.0
                      for k in keys), f"round_zoo {name}: bad metrics {r}")
        per_round, final = metric_deltas(res_short.rounds, res_cpu.rounds)
        stages = ("local_train", "server", "apply", "eval")
        runs[name] = {
            "eval_rounds": [r["round"] for r in res.rounds],
            **{k: [r[k] for r in res.rounds] for k in keys},
            "cpu_final": {k: res_cpu.rounds[-1][k] for k in keys},
            "card_vs_cpu": {"largest_per_round_delta": per_round,
                            "final_abs_delta": final,
                            "tolerance": ZOO_TOL},
            "bytes": zoo_bytes(name, short[name], cpu_runs[name]),
            "round_wall_ms_median": float(np.median(
                [s["wall_ms"] for s in res.stage_ms])),
            "stage_ms_median": {k: float(np.median(
                [s.get(k, 0.0) for s in res.stage_ms])) for k in stages},
            "sim_wall_s": wall_s}
        tables[name] = {"rounds": res.rounds, "rounds_cpu": res_cpu.rounds,
                        "stage_ms": res.stage_ms}
    host = card_runs["fedprox"][1]
    _, st_res, st_wall = stacked
    per_round, final = metric_deltas(st_res.rounds, host.rounds)
    fedprox_stacked = {
        "largest_per_round_delta": per_round, "final_abs_delta": final,
        "tolerance": ZOO_TOL,
        "bytes_equal": (st_res.comm.total_c2s == host.comm.total_c2s
                        and st_res.comm.total_s2c == host.comm.total_s2c
                        and st_res.storage_bytes == host.storage_bytes),
        "round_wall_ms_median": float(np.median(
            [s["wall_ms"] for s in st_res.stage_ms])),
        "sim_wall_s": st_wall}
    ZOO_OUT.parent.mkdir(parents=True, exist_ok=True)
    ZOO_OUT.write_text(json.dumps({"card": card, "runs": tables,
                                   "fedprox_stacked": st_res.stage_ms}))
    emit({"phase": "round_zoo", "card": card, "clients": N_CLIENTS,
          "tasks": bench.n_tasks, "rounds": ZOO_ROUNDS,
          "card_vs_cpu_rounds": ZOO_CPU_ROUNDS,
          "epochs": ZOO_EPOCHS, "eval_every": ZOO_EVAL_EVERY, "runs": runs,
          "fedprox_host_vs_stacked": fedprox_stacked,
          "cpu_reruns_s": cpu_s,
          "launches": {k: v for k, v in launches.items() if v},
          "expected_launches": {k: v for k, v in expect.items() if v},
          "kernel_vs_plain_on_path": on_path,
          "detail": str(ZOO_OUT.relative_to(ROOT))})
    for name, r in runs.items():
        check(r["bytes"]["equal"],
              f"round_zoo {name}: card and CPU bytes differ: {r['bytes']}")
        check(all(v <= ZOO_TOL for v in r["card_vs_cpu"]
                  ["largest_per_round_delta"].values()),
              f"round_zoo {name}: card vs CPU {r['card_vs_cpu']} > {ZOO_TOL}")
    check(all(v <= ZOO_TOL for v in per_round.values())
          and fedprox_stacked["bytes_equal"],
          f"round_zoo: FedProx host vs stacked {fedprox_stacked}")
    check(launches == expect,
          f"round_zoo launches {launches}, expected {expect}")
    return launches, {n: r["max_abs_err"] for n, r in on_path.items()}


def phase_server_scale(dev, card):
    """ring push -> KL relevance -> flatten -> fused aggregate -> unflatten
    at the C of BENCH_server_round.json / BENCH_mesh_round.json, with the
    ring full (k rounds pushed). Device ms per stage (CUDA events), and the
    host wall of a whole ``server_round_stacked`` call."""
    cfg = EM.EdgeModelConfig()                 # 512 classes: P = 57664
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for C in SCALE_CLIENTS:
        heads = EM.stack_heads([EM.init_adaptive_layers(cfg, gen)
                                for _ in range(C)], dev)
        strat = FedSTIL(cfg, n_clients=C, history_len=HIST_K)
        walls = []
        for rnd in range(HIST_K + 2):
            up = {"theta": heads,
                  "task_feature": task_features(gen, dev, C)}
            t0 = time.perf_counter()
            strat.server_round_stacked(rnd, up)
            walls.append((time.perf_counter() - t0) * 1e3)
        ring = strat._ring
        check(bool(ring.valid.all()), "server_round_scale: ring not full")
        feats = task_features(gen, dev, C)
        mask = torch.ones((C,), device=dev)
        W = ring_relevance(ring.buf, ring.valid, forgetting_ratio=0.5)
        flat, meta = flatten_stacked(heads)
        check(flat.shape == (C, P_EDGE), f"P = {flat.shape[1]} != {P_EDGE}")
        B_flat, _ = fused_relevance_aggregate(W, flat)
        emit({"phase": "server_round_scale", "card": card, "clients": C,
              "params_per_client": P_EDGE, "history": HIST_K,
              "feature_dim": CFG.proto_dim,
              "ring_push_ms": time_ms(lambda: ring_push(
                  ring.buf, ring.valid, ring.stale, feats, mask)),
              "relevance_ms": time_ms(lambda: ring_relevance(
                  ring.buf, ring.valid, forgetting_ratio=0.5)),
              "kl_similarity_ms": time_ms(lambda: kl_similarity(
                  ring.buf[:, 0].contiguous(),
                  ring.buf.reshape(C * HIST_K, -1))),
              "flatten_ms": time_ms(lambda: flatten_stacked(heads)),
              "aggregate_ms": time_ms(lambda: fused_relevance_aggregate(
                  W, flat)),
              "unflatten_ms": time_ms(lambda: unflatten_stacked(B_flat,
                                                                meta)),
              "server_round_wall_ms": float(np.median(walls[2:])),
              "server_round_wall_ms_first": walls[0]})
        del heads, strat, flat, B_flat, W
        torch.cuda.empty_cache()


def phase_wire_round_scale(dev, card):
    """``BatchedCodec.roundtrip`` of a (C, 57664) payload under
    ``delta+topk`` and ``topk+int8`` at C = 100 and 1000, past the
    keyframe: device ms of each kernel on the steady-state operands (the
    path's encode and decode, and the four one-stage kernels they fold) and
    of the whole roundtrip (CUDA events), the roundtrip's peak device
    memory above what is held before it, and the wire bytes a client
    against the dense payload (topk+int8: against the prediction from the
    shapes). The peak is taken untraced and under a tracer (the encode's
    metrics); returns {(codec, C): (peak untraced, peak traced)}."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    peaks_out = {}
    for codec in (CODEC, CODEC_INT8):
        for C in SCALE_CLIENTS:
            prog = BatchedCodec(make_codec(codec), P_EDGE)
            base = torch.randn((C, P_EDGE), generator=gen, device=dev)
            prog.roundtrip(base)                              # the keyframe
            mat = base + 0.01 * torch.randn((C, P_EDGE), generator=gen,
                                            device=dev)
            recon, buffers = prog.roundtrip(mat)
            check("idx_bits" in buffers, "wire_round_scale: no sparse payload")
            r = mat - recon                  # the next roundtrip's residual
            vals, idx = batched_topk_pack(r, group=GROUP, kg=KG)
            packed = batched_idx_bitpack(idx, group=GROUP, kg=KG)
            per_client = prog.per_client_bytes(buffers)
            rec = {"phase": "wire_round_scale", "card": card, "clients": C,
                   "params_per_client": P_EDGE, "codec": codec, "kg": KG,
                   "wire_bytes_per_client": per_client,
                   "dense_bytes_per_client": 4 * P_EDGE,
                   "wire_over_dense": per_client / (4 * P_EDGE),
                   "recon_max_abs_err": float((recon - mat).abs().max()),
                   "pack_ms": time_ms(lambda: batched_topk_pack(
                       r, group=GROUP, kg=KG)),
                   "bitpack_ms": time_ms(lambda: batched_idx_bitpack(
                       idx, group=GROUP, kg=KG)),
                   "bitunpack_ms": time_ms(lambda: batched_idx_bitunpack(
                       packed, k=prog.k, group=GROUP, kg=KG)),
                   "unpack_ms": time_ms(lambda: batched_topk_unpack(
                       vals, idx, p=P_EDGE, group=GROUP, kg=KG)),
                   "encode_ms": time_ms(lambda: batched_topk_encode(
                       r, group=GROUP, kg=KG)),
                   "decode_ms": time_ms(lambda: batched_topk_decode(
                       vals, packed, k=prog.k, p=P_EDGE, group=GROUP,
                       kg=KG))}
            if codec == CODEC_INT8:
                q, sc = batched_quantize(vals, chunk=prog.chunk)
                rec.update(
                    predicted_wire_bytes_per_client=INT8_SCALE_WIRE,
                    quantize_ms=time_ms(lambda: batched_quantize(
                        vals, chunk=prog.chunk)),
                    dequantize_ms=time_ms(lambda: batched_dequantize(
                        q, sc, chunk=prog.chunk)),
                    decode_int8_ms=time_ms(lambda: batched_topk_decode_int8(
                        q, sc, packed, k=prog.k, p=P_EDGE, group=GROUP,
                        kg=KG, chunk=prog.chunk)))
                check(per_client == INT8_SCALE_WIRE,
                      f"wire_round_scale {codec}: {per_client} bytes a "
                      f"client, predicted {INT8_SCALE_WIRE}")
            rec["roundtrip_ms"] = time_ms(lambda: prog.roundtrip(mat))
            # untraced (the encode computes no metric), then traced
            rec["roundtrip_peak_bytes_above_held"] = roundtrip_peak(prog, mat)
            with obs.active(obs.Tracer()):
                rec["roundtrip_peak_bytes_above_held_traced"] = \
                    roundtrip_peak(prog, mat)
            check(prog.last_metrics is not None, "wire_round_scale: the "
                  "traced encode computed no metric")
            peaks_out[(codec, C)] = (
                rec["roundtrip_peak_bytes_above_held"],
                rec["roundtrip_peak_bytes_above_held_traced"])
            emit(rec)
            del prog, base, mat, recon, buffers, r, vals, idx, packed
            torch.cuda.empty_cache()
    return peaks_out


def roundtrip_peak(prog, mat) -> int:
    """Device bytes one ``prog.roundtrip(mat)`` allocates above what is
    held before it."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    prog.roundtrip(mat)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held


# ---------------------------------------------------------------------------
# telemetry: what tracing costs, off and on
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def counting_syncs():
    """{"span_sync", "cuda_synchronize"}: the calls made inside the block
    to a live span's ``sync`` and to ``torch.cuda.synchronize``."""
    n = {"span_sync": 0, "cuda_synchronize": 0}
    span_sync, cuda_sync = obs._Span.sync, torch.cuda.synchronize

    def counted_span_sync(self, value):
        n["span_sync"] += 1
        return span_sync(self, value)

    def counted_cuda_sync(*args, **kw):
        n["cuda_synchronize"] += 1
        return cuda_sync(*args, **kw)

    obs._Span.sync, torch.cuda.synchronize = (counted_span_sync,
                                              counted_cuda_sync)
    try:
        yield n
    finally:
        obs._Span.sync, torch.cuda.synchronize = span_sync, cuda_sync


def null_hook_us(dev):
    """Host microseconds of one null-tracer hook, over NULL_HOOK_CALLS
    calls each: a span with a sync, a metric, an ``is_active`` check."""
    x = torch.zeros(1, device=dev)
    out = {}
    with obs.suspended():
        for name, hook in (
                ("span", lambda: obs.span("round.local_train", cat="phase",
                                          round=0)),
                ("metric", lambda: obs.metric("server.relevance", None,
                                              round=0)),
                ("is_active", obs.is_active)):
            t0 = time.perf_counter()
            if name == "span":
                for _ in range(NULL_HOOK_CALLS):
                    with hook() as sp:
                        sp.sync(x)
            else:
                for _ in range(NULL_HOOK_CALLS):
                    hook()
            out[name] = (time.perf_counter() - t0) / NULL_HOOK_CALLS * 1e6
    return out


def server_tracing_tax(dev):
    """The reference's tracing-tax measure (``benchmarks/server_round.py``
    ``measure_overhead``) on the card: the stacked server round at
    TAX_CLIENTS over resident heads, TAX_ITERS rounds a timing, the null
    tracer (``obs.suspended``) against a live one, min of TAX_REPEATS
    each; host wall ms of a round ending in a device sync."""
    cfg = EM.EdgeModelConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    heads = EM.stack_heads([EM.init_adaptive_layers(cfg, gen)
                            for _ in range(TAX_CLIENTS)], dev)
    feats = task_features(gen, dev, (TAX_ITERS + 1) * TAX_CLIENTS).reshape(
        TAX_ITERS + 1, TAX_CLIENTS, -1)
    strat = FedSTIL(cfg, n_clients=TAX_CLIENTS)

    def one_round(r):
        strat.server_round_stacked(r, {"theta": heads,
                                       "task_feature": feats[r % len(feats)]})
        torch.cuda.synchronize(dev)

    def timed():
        t0 = time.perf_counter()
        for r in range(1, TAX_ITERS + 1):
            one_round(r)
        return (time.perf_counter() - t0) / TAX_ITERS

    one_round(0)
    tracer, off, on = obs.Tracer(), [], []
    for _ in range(TAX_REPEATS):
        with obs.suspended():
            off.append(timed())
        with obs.active(tracer):
            on.append(timed())
    base, traced = min(off), min(on)
    frac = max(0.0, traced - base) / base
    stages = report.summarize(tracer.events)["stages"]
    return {"clients": TAX_CLIENTS, "iters": TAX_ITERS,
            "repeats": TAX_REPEATS, "untraced_ms": base * 1e3,
            "traced_ms": traced * 1e3, "untraced_ms_all": [
                v * 1e3 for v in off], "traced_ms_all": [v * 1e3 for v in on],
            "overhead_frac": frac, "gate": OVERHEAD_GATE,
            "within_gate": bool(frac < OVERHEAD_GATE),
            "stage_mean_ms": {k: g["mean_s"] * 1e3
                              for k, g in stages.items()}}


def phase_telemetry(dev, card, codec_peaks):
    """What tracing costs on the card: the server round's tracing tax at
    C = 100 (reported against the reference's 2% rule), the null hooks'
    cost as a share of the untraced stacked round (fails at 2% or more),
    the stacked round untraced and traced over the same TELEMETRY_ROUNDS
    (round wall of each; the untraced runs make no device sync from a
    span nor any other), the traced run's phase shares and its Chrome
    trace written and read back, and the codec roundtrip's peak at
    C = 1000 untraced and traced (``wire_round_scale``)."""
    bench = FederatedReIDBenchmark(seed=SEED)
    cfg = EM.EdgeModelConfig(n_classes=bench.n_classes)

    synchronize = torch.cuda.synchronize       # outside counting_syncs

    def run(rounds, trace=None):
        synchronize(dev)
        t0 = time.perf_counter()
        res = run_simulation(FedSTIL(cfg, n_clients=N_CLIENTS), bench,
                             rounds=rounds, seed=SEED, engine="stacked",
                             device=dev, trace=trace)
        synchronize(dev)
        return res, (time.perf_counter() - t0) * 1e3

    setup, untraced, traced, syncs_off, syncs_on = [], [], [], [], []
    for _ in range(2):
        setup.append(run(0)[1])
        with counting_syncs() as n:
            res_off, ms = run(TELEMETRY_ROUNDS)
        untraced.append(ms)
        syncs_off.append(dict(n))
        tracer = obs.Tracer()
        with counting_syncs() as n:
            res_on, ms = run(TELEMETRY_ROUNDS, tracer)
        traced.append(ms)
        syncs_on.append(dict(n))
    check(res_on.rounds == res_off.rounds
          and res_on.comm_breakdown() == res_off.comm_breakdown(),
          "telemetry: the traced round's results differ from the untraced")
    check(res_off.stage_ms == [] and len(res_on.stage_ms) == TELEMETRY_ROUNDS,
          "telemetry: stage_ms filled untraced or empty traced")
    round_ms = lambda walls: (min(walls) - min(setup)) / TELEMETRY_ROUNDS
    untraced_round, traced_round = round_ms(untraced), round_ms(traced)

    spans = [e for e in tracer.events if e["kind"] == "span"]
    metrics = [e for e in tracer.events if e["kind"] == "metric"]
    hooks = {"spans": len(spans) / TELEMETRY_ROUNDS,
             "metrics": len(metrics) / TELEMETRY_ROUNDS,
             "span_syncs": syncs_on[-1]["span_sync"] / TELEMETRY_ROUNDS}
    hook_us = null_hook_us(dev)
    null_us = (hooks["spans"] * hook_us["span"]
               + hooks["metrics"] * (hook_us["metric"] + hook_us["is_active"]))
    null_share = null_us / (untraced_round * 1e3)

    summary = report.summarize(tracer.events)
    TRACE_OUT.parent.mkdir(parents=True, exist_ok=True)
    TRACE_OUT.write_text(json.dumps(obs.chrome_trace(tracer.events)))
    reread = json.loads(TRACE_OUT.read_text())["traceEvents"]
    tax = server_tracing_tax(dev)
    peak = {codec: {"untraced": codec_peaks[(codec, max(SCALE_CLIENTS))][0],
                    "traced": codec_peaks[(codec, max(SCALE_CLIENTS))][1]}
            for codec in (CODEC, CODEC_INT8)}
    emit({"phase": "telemetry", "card": card, "clients": N_CLIENTS,
          "rounds": TELEMETRY_ROUNDS, "engine": "stacked",
          "setup_ms": setup, "untraced_run_ms": untraced,
          "traced_run_ms": traced,
          "untraced_round_wall_ms": untraced_round,
          "traced_round_wall_ms": traced_round,
          "traced_stage_wall_ms_median": float(np.median(
              [r["wall_ms"] for r in res_on.stage_ms])),
          "syncs_untraced": syncs_off, "syncs_traced": syncs_on,
          "hooks_per_round": hooks, "null_hook_us": hook_us,
          "null_hooks_us_per_round": null_us,
          "null_hooks_share_of_untraced_round": null_share,
          "phase_share": {k: g["share"]
                          for k, g in summary["phases"].items()},
          "phase_mean_ms": {k: g["mean_s"] * 1e3
                            for k, g in summary["phases"].items()},
          "stage_mean_ms": {k: g["mean_s"] * 1e3
                            for k, g in summary["stages"].items()},
          "chrome_trace": {"path": str(TRACE_OUT.relative_to(ROOT)),
                           "events": len(reread)},
          "server_tracing_tax": tax,
          "codec_roundtrip_peak_bytes_c1000": peak})
    check(all(n == {"span_sync": 0, "cuda_synchronize": 0}
              for n in syncs_off),
          f"telemetry: the untraced round synced the device: {syncs_off}")
    check(syncs_on[-1]["span_sync"] > 0, "telemetry: no span synced traced")
    check(null_share < OVERHEAD_GATE,
          f"telemetry: null hooks {null_share:.4%} of the untraced round "
          f"(>= {OVERHEAD_GATE:.0%})")
    check(len(reread) == len(spans) + len(metrics),
          "telemetry: the Chrome trace lost events")
    check(set(summary["phases"]) == {"round.gather", "round.local_train",
                                     "round.server", "round.apply",
                                     "round.eval"},
          f"telemetry: phases {sorted(summary['phases'])}")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the LM edge train step (slice 6a)
# ---------------------------------------------------------------------------


def lm_batches(rng, n, batch, seq, cfg, dev):
    return [lm_batch_on(cfg, rng, batch, seq, dev) for _ in range(n)]


def rel_l2_by_leaf(got, want):
    """{leaf path: ||got - want|| / ||want||} over two trees, in fp32."""
    return {"/".join(map(str, path)): float(torch.linalg.vector_norm(
        a.float() - b.float())) / max(float(torch.linalg.vector_norm(
            b.float())), 1e-30)
        for path, a, b in zip(leaf_paths(want), tree_leaves(got),
                              tree_leaves(want))}


def flash_path_errs(seen):
    """Each flash kernel against its plain version on the operands of its
    last call in the train step (the path is causal, no window): the last
    trunk layer's q, k, v for the forward, the adaptive layer's for the
    rest."""
    kw = dict(causal=True, window=0)
    out = {}
    for name in FLASH_STAGES:
        args = tuple(a.detach() for a in seen[name])
        with torch.no_grad():
            got = KERNELS[name]["fn"](*args, **kw)
            want = FLASH_PLAIN[name](*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        out[name] = {"shapes": [list(a.shape) for a in args],
                     **flash_outputs_check("lm_train on its path operands:",
                                           name, got, want, True)}
    return out


# kernel name substrings -> group, first match wins (cuBLAS's Hopper
# matmuls are named nvjet_*)
LM_KERNEL_GROUPS = (("flash_fwd_tensor_cores", ("fwd_kernel_sm90",)),
                    ("flash_bwd_tensor_cores", ("dq_kernel_sm90",
                                                "dkv_kernel_sm90")),
                    ("flash", ("fwd_kernel", "dq_kernel", "dkv_kernel")),
                    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
                    ("combine", ("combine",)),
                    ("copy", ("copy",)),
                    ("elementwise", ("elementwise", "vectorized")),
                    ("reduce", ("reduce",)))


def lm_step_profile(step, st, batch):
    """One more split step under torch.profiler (``device_profile``):
    device ms by kernel group (the tensor-core flash forward, the
    tensor-core flash dQ and dK/dV, the FMA flash kernels, cuBLAS
    matmuls, the combine, copies and casts, other elementwise and
    reduction kernels, the rest) and the device's idle share."""
    return device_profile(lambda: step(st.frozen, st.B, st.trainable,
                                       st.opt_state, batch))


def phase_lm_train(dev, card):
    """The dense LM's FedSTIL edge train step at full width on the card:
    ``make_train_step(tie_lambda=1e-4)`` of ``launch/train.py`` on
    qwen3-1.7b (all 28 layers, bf16, seed-0 weights), B=2 x S=4096: one
    warm-up and three timed steps (CUDA events), the flash launches of each
    step (27 forward for the frozen trunk; forward+lse, dQ and dK/dV for
    the adaptive layer; all on the tensor cores), each kernel against its
    plain version on its last on-path operands, and the first step again with attention routed to
    the plain versions on the card. Returns (launches, on-path errors)."""
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    opt = adam(lr=1e-3, weight_decay=1e-5,
               schedule=cosine_schedule(warmup=20, total=LM_STEPS))
    t0 = time.perf_counter()
    st = init_train_state(cfg, torch.Generator(device=dev).manual_seed(SEED),
                          optimizer=opt)
    batches = lm_batches(np.random.default_rng(SEED), LM_STEPS, LM_BATCH,
                         LM_SEQ, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(st.frozen)) + sum(
        t.numel() for t in tree_leaves(st.B))
    step = make_train_step(cfg, optimizer=opt, tie_lambda=LM_TIE)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    per_step, tc_step, step_ms, losses = [], [], [], []
    with last_operands(FLASH_STAGES, by_reference=FLASH_STAGES) as seen:
        tr, os_ = st.trainable, st.opt_state
        for b in batches:
            before = {n: KERNELS[n]["fn"].launches for n in FLASH_STAGES}
            before_tc = {n: KERNELS[n]["fn"].tc_launches
                         for n in FLASH_STAGES}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tr, os_, m = step(st.frozen, st.B, tr, os_, b)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
            per_step.append({n: KERNELS[n]["fn"].launches - before[n]
                             for n in FLASH_STAGES})
            tc_step.append({n: KERNELS[n]["fn"].tc_launches - before_tc[n]
                            for n in FLASH_STAGES})
    launches = counts()
    peak_mem = torch.cuda.max_memory_allocated(dev)
    del tr, os_, m
    on_path = flash_path_errs(seen)
    del seen
    profile_row = lm_step_profile(step, st, batches[0])

    # the first step's objective and gradients, kernels vs plain versions
    (loss_k, _, _), g_k = adaptive_loss_and_grads(
        cfg, st.frozen, st.B, st.trainable, batches[0], tie_lambda=LM_TIE)
    with patched_ops(FLASH_PLAIN):
        (loss_p, _, _), g_p = adaptive_loss_and_grads(
            cfg, st.frozen, st.B, st.trainable, batches[0],
            tie_lambda=LM_TIE)
    by_leaf = rel_l2_by_leaf(g_k, g_p)
    swap = {"loss_kernels": float(loss_k), "loss_plain": float(loss_p),
            "abs_loss_delta": abs(float(loss_k) - float(loss_p)),
            "grad_rel_l2_worst_leaf": max(by_leaf.values()),
            "grad_rel_l2_by_leaf": by_leaf}
    del g_k, g_p

    n_trunk = cfg.n_layers - cfg.n_adaptive_layers
    expect_step = {"flash_attention_fwd": n_trunk,
                   "flash_attention_fwd_lse": cfg.n_adaptive_layers,
                   "flash_attention_dq": cfg.n_adaptive_layers,
                   "flash_attention_dkv": cfg.n_adaptive_layers}
    timed = step_ms[1:]
    tokens = LM_BATCH * LM_SEQ
    emit({"phase": "lm_train", "card": card, "arch": LM_ARCH,
          "batch": LM_BATCH, "seq": LM_SEQ, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "head_dim": cfg.hd, "params": n_params,
          "adaptive_params": sum(t.numel() for t in tree_leaves(st.B)),
          "dtype": cfg.param_dtype, "init_s": init_s,
          "warmup_step_ms": step_ms[0], "step_ms": timed,
          "median_step_ms": float(np.median(timed)),
          "tokens_per_s": tokens / (float(np.median(timed)) / 1e3),
          "peak_mem_bytes": peak_mem, "losses": losses,
          "launches_per_step": per_step,
          "tensor_core_launches_per_step": tc_step,
          "launches": {n: launches[n] for n in FLASH_STAGES
                       + ("adaptive_combine",)},
          "kernel_vs_plain_on_path": on_path, "plain_attention_step": swap,
          "profile": profile_row,
          "phase_s": time.perf_counter() - t_phase})
    check(all(np.isfinite(losses)), f"lm_train: losses {losses}")
    check(all(p == expect_step for p in per_step),
          f"lm_train launches a step {per_step}, expected {expect_step}")
    check(all(p == expect_step for p in tc_step),
          f"lm_train tensor-core launches a step {tc_step}, expected "
          f"{expect_step}")
    # one combine a step, one launch per dtype of the adaptive tree (each
    # group is under MAX_LEAVES)
    groups = len({t.dtype for t in tree_leaves(st.B)})
    check(launches["adaptive_combine"] == groups * LM_STEPS,
          f"lm_train: {launches['adaptive_combine']} combine launches, "
          f"expected {groups} a step (one per dtype)")
    check(swap["abs_loss_delta"] <= LM_SWAP_LOSS_TOL
          and swap["grad_rel_l2_worst_leaf"] <= LM_SWAP_GRAD_TOL,
          f"lm_train: kernels vs plain attention {swap}")
    return launches, {n: r["max_abs_err"] for n, r in on_path.items()}, \
        (cfg, st, batches[0], float(np.median(timed)))


def phase_lm_train_reduced(dev, card):
    """The GQA-reduced config (qwen3-1.7b reduced with 2 kv heads: R = 2,
    hd 64, fp32) trained 10 steps on the card and on the CPU from the same
    weights and batches (S = 200: a ragged last tile), per-step loss
    within 1e-4, no stage on a tensor-core kernel; then one full
    fine-tuning step on both, which runs forward+lse, dQ and dK/dV on
    every layer."""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(LM_ARCH).reduced(), n_kv_heads=2)
    params = lm.init_params(cfg, torch.Generator().manual_seed(SEED))
    host = lm_batches(np.random.default_rng(SEED), LM_RED_STEPS,
                      LM_RED_BATCH, LM_RED_SEQ, cfg, "cpu")

    def opt():
        return adam(lr=1e-3, weight_decay=1e-5,
                    schedule=cosine_schedule(warmup=20, total=LM_RED_STEPS))

    def run(device):
        p = tree_map(lambda t: t.to(device), params)
        bs = [tree_map(lambda t: t.to(device), b) for b in host]
        o = opt()
        st = train_state_from_params(cfg, p, o)
        step = make_train_step(cfg, optimizer=o, tie_lambda=LM_TIE)
        tr, os_, losses = st.trainable, st.opt_state, []
        for b in bs:
            tr, os_, m = step(st.frozen, st.B, tr, os_, b)
            losses.append(float(m["loss"]))
        o = opt()
        _, _, m = make_full_train_step(cfg, optimizer=o)(
            p, init_opt_state(o, p), bs[0])
        return losses, float(m["loss"])

    zero_counts()
    card_losses, card_full = run(dev)
    launches = {n: KERNELS[n]["fn"].launches for n in FLASH_STAGES}
    tc = {n: KERNELS[n]["fn"].tc_launches for n in FLASH_STAGES}
    cpu_losses, cpu_full = run("cpu")
    deltas = [abs(a - b) for a, b in zip(card_losses, cpu_losses)]
    emit({"phase": "lm_train_reduced", "card": card, "config": cfg.name,
          "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.hd,
          "batch": LM_RED_BATCH, "seq": LM_RED_SEQ,
          "card_losses": card_losses, "cpu_losses": cpu_losses,
          "max_step_delta": max(deltas), "full_step_loss": [card_full,
                                                            cpu_full],
          "launches": launches, "tensor_core_launches": tc,
          "phase_s": time.perf_counter() - t_phase})
    check(max(deltas) <= LM_RED_TOL and abs(card_full - cpu_full)
          <= LM_RED_TOL, f"lm_train_reduced card vs CPU: step deltas "
          f"{deltas}, full step {card_full} vs {cpu_full}")
    n = cfg.n_layers
    expect = {"flash_attention_fwd": LM_RED_STEPS,
              "flash_attention_fwd_lse": LM_RED_STEPS + n,
              "flash_attention_dq": LM_RED_STEPS + n,
              "flash_attention_dkv": LM_RED_STEPS + n}
    check(launches == expect,
          f"lm_train_reduced launches {launches}, expected {expect}")
    check(not any(tc.values()), f"lm_train_reduced (fp32) ran a bf16 "
          f"tensor-core kernel: {tc}; fp32 takes the FMA kernels")


# ---------------------------------------------------------------------------
# lm_decode and lm_families: decode serving and the LM zoo
# ---------------------------------------------------------------------------

DECODE_ARCH = "qwen1.5-0.5b"            # serve_lm's default arch
DECODE_GATE_BATCH, DECODE_GATE_SEQ = 4, 64
DECODE_GATE = 0.95                      # tests/test_models_smoke.py's bar
# the bf16 decode-vs-forward logits' relative L2 (over the true vocab):
# 10x the reading of the first full H100 run, 0.0162 (PERF.md);
# decode and forward round their bf16 activations at different points
DECODE_BF16_REL_L2 = 0.16
DECODE_TIMED, DECODE_WARMUP = 20, 1
DECODE_32K_BATCH = 8                    # decode_32k's global batch 128, cut
DECODE_RING_WINDOW = LONG_CONTEXT_WINDOW
DECODE_RING_POS = get_shape("long_500k").seq_len - 1
FAMILY_ARCHS = ("rwkv6-1.6b", "zamba2-2.7b", "qwen3-moe-235b-a22b")
FAMILY_MOE_LAYERS = 3                   # 2 trunk + 1 adaptive of its 94
FAMILY_GATE_BATCH, FAMILY_GATE_SEQ = 2, 32
FAMILY_DECODE_BATCH, FAMILY_DECODE_SLOTS = 8, 4096
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ = 2, 32
FAMILY_RED_STEPS, FAMILY_RED_BATCH, FAMILY_RED_SEQ = 3, 2, 32
FAMILY_RED_TOL = 1e-4                   # lm_train_reduced's bar


# lm_roofline: lm_train's split step priced against the H100's roofline
# (``sharding/analysis.py``'s constants): its FLOPs counted on the card (the
# flash kernels launched) and on meta tensors (the same code, no card), its
# median ms beside t_compute and t_memory, its peak beside the meta
# estimate; the card's own bf16 matmul rate and copy bandwidth beside the
# constants; and ``launch/dryrun.py`` on lm_train's arch (both production
# meshes), started in the background at the script's start
ROOFLINE_MM = 8192                       # bf16 (n, n) x (n, n) torch.mm
ROOFLINE_COPY_BYTES = 1 << 30            # one device-to-device copy
DRYRUN_OUT = ROOT / "build" / "dryrun_torch"
DRYRUN_ARGS = ("--arch", LM_ARCH, "--shape", "train_4k", "--multi-pod",
               "both")
DRYRUN_TIMEOUT_S = 600


def start_dryrun():
    """``python -m repro_torch.launch.dryrun`` on lm_train's arch in a
    subprocess (host work only: meta tensors in a fake world), killed at
    the script's exit -> (the process, its start time)."""
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    # one thread: meta tensors do no arithmetic, and the CPU reruns share
    # the host's cores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGS,
         "--out", str(DRYRUN_OUT)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, time.perf_counter()


def join_dryrun(started):
    """The dryrun's records (it must end with failures=0) and the seconds
    from its start to this join."""
    proc, t0 = started
    out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    check(proc.returncode == 0 and "dryrun complete; failures=0" in out,
          f"launch.dryrun exited {proc.returncode}: {out[-2000:]} "
          f"{err[-2000:]}")
    recs = [json.loads(p.read_text()) for p in sorted(DRYRUN_OUT.glob(
        "*.json"))]
    check(len(recs) == 2 and all(r["ok"] for r in recs),
          f"launch.dryrun records {[r.get('ok') for r in recs]}")
    return {"command": "python -m repro_torch.launch.dryrun "
            + " ".join(DRYRUN_ARGS), "failures": 0,
            "joined_after_s": time.perf_counter() - t0,
            "records": {r["mesh"]: {
                "flops_per_device": r["cost"]["flops"],
                "analytic_flops_per_device":
                    r["analytic"]["flops_per_device"],
                "collective_bytes_per_device":
                    r["collectives"]["total_bytes"],
                "internode_bytes": r["collectives"]["internode_bytes"],
                "bottleneck": r["roofline"]["bottleneck"],
                "lower_s": r["lower_s"]} for r in recs}}


def card_rates(dev):
    """The card's bf16 matmul rate and copy bandwidth (CUDA events, median
    of REPS) beside the constants ``sharding/analysis.py`` prices with."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.randn((ROOFLINE_MM,) * 2, generator=g, device=dev,
                    dtype=torch.bfloat16)
    b = torch.randn((ROOFLINE_MM,) * 2, generator=g, device=dev,
                    dtype=torch.bfloat16)
    mm_ms = time_ms(lambda: torch.mm(a, b))
    del a, b
    n = ROOFLINE_COPY_BYTES // 4
    src = torch.empty(n, device=dev)
    dst = torch.empty(n, device=dev)
    copy_ms = time_ms(lambda: dst.copy_(src))
    del src, dst
    torch.cuda.empty_cache()
    mm_rate = 2 * ROOFLINE_MM ** 3 / (mm_ms / 1e3)
    # a copy reads and writes every byte
    copy_rate = 2 * ROOFLINE_COPY_BYTES / (copy_ms / 1e3)
    return {"mm_bf16_n": ROOFLINE_MM, "mm_ms": mm_ms,
            "mm_flops_per_s": mm_rate,
            "peak_flops_bf16": AN.PEAK_FLOPS_BF16,
            "mm_share_of_peak": mm_rate / AN.PEAK_FLOPS_BF16,
            "copy_bytes": ROOFLINE_COPY_BYTES, "copy_ms": copy_ms,
            "copy_read_write_bytes_per_s": copy_rate,
            "hbm_bw": AN.HBM_BW, "copy_share_of_hbm_bw": copy_rate / AN.HBM_BW}


def phase_lm_roofline(dev, card, train_ctx, dryrun):
    """lm_train's split step (qwen3-1.7b, B=2 x S=4096, bf16) priced
    against the H100's roofline: one step counted (``OpCounter``) on the
    card with the flash kernels launched (27 / 1 / 1 / 1) and the same step
    on meta tensors, FLOPs equal; three timed steps' median beside
    t_compute = FLOPs / peak and t_memory = the analytic model's HBM bytes
    / HBM bandwidth (tp 1, dp 1), the roofline share and the MFU
    (``analytic_model_flops``); the step's peak above what was held beside
    the meta estimate; the card's measured rates; the dryrun subprocess's
    records. Reported, not gated, but for the FLOPs, the launches and the
    dryrun's failures=0. Returns the counted step's launches."""
    t_phase = time.perf_counter()
    cfg, st, batch, _ = train_ctx
    opt = adam(lr=1e-3, weight_decay=1e-5,
               schedule=cosine_schedule(warmup=20, total=LM_STEPS))
    step = make_train_step(cfg, optimizer=opt, tie_lambda=LM_TIE)

    def run(state, b):
        return step(state.frozen, state.B, state.trainable, state.opt_state,
                    b)

    run(st, batch)                                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    zero_counts()
    with AN.OpCounter() as on_card:
        out = run(st, batch)
    torch.cuda.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated(dev) - held
    del out
    step_ms = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(st, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    median_ms = float(np.median(step_ms))

    t0 = time.perf_counter()
    meta_st = init_train_state(cfg, LMLAYERS.SHAPES_ONLY, optimizer=opt)
    meta_batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in batch.items()}
    with AN.OpCounter() as on_meta:
        run(meta_st, meta_batch)
    meta_s = time.perf_counter() - t0

    shape = ShapeConfig("lm_train", LM_SEQ, LM_BATCH, "train")
    analytic = analytic_roofline(cfg, shape, tp=1, dp=1, pods=1)
    model_flops = AN.analytic_model_flops(cfg, shape)
    t_compute = on_card.flops / AN.PEAK_FLOPS_BF16
    t_memory = analytic["hbm_bytes_per_device"] / AN.HBM_BW
    step_s = median_ms / 1e3
    n_trunk = cfg.n_layers - cfg.n_adaptive_layers
    expect = {"flash_attention_fwd": n_trunk,
              "flash_attention_fwd_lse": cfg.n_adaptive_layers,
              "flash_attention_dq": cfg.n_adaptive_layers,
              "flash_attention_dkv": cfg.n_adaptive_layers}
    flash = {n: launches[n] for n in FLASH_STAGES}
    rates = card_rates(dev)
    dry = join_dryrun(dryrun)
    emit({"phase": "lm_roofline", "card": card, "arch": LM_ARCH,
          "batch": LM_BATCH, "seq": LM_SEQ,
          "flops_on_card": on_card.flops, "flops_on_meta": on_meta.flops,
          "flops_by_op": on_card.flops_by_op,
          "analytic_flops": analytic["flops_per_device"],
          "counted_over_analytic": on_card.flops
          / analytic["flops_per_device"],
          "model_flops": model_flops,
          "step_ms": step_ms, "median_step_ms": median_ms,
          "t_compute_ms": t_compute * 1e3, "t_memory_ms": t_memory * 1e3,
          "analytic_hbm_bytes": analytic["hbm_bytes_per_device"],
          "roofline_share": max(t_compute, t_memory) / step_s,
          "mfu": model_flops / (step_s * AN.PEAK_FLOPS_BF16),
          "peak_mem_above_held": peak,
          "peak_live_estimate_meta": on_meta.peak_live_bytes,
          "peak_over_estimate": peak / max(on_meta.peak_live_bytes, 1),
          "meta_walk_s": meta_s, "launches": flash,
          "combine_launches": launches["adaptive_combine"],
          "rates": rates, "dryrun": dry,
          "phase_s": time.perf_counter() - t_phase})
    check(on_card.flops == on_meta.flops > 0,
          f"lm_roofline: FLOPs on the card {on_card.flops} vs meta "
          f"{on_meta.flops}")
    check(flash == expect,
          f"lm_roofline: flash launches {flash}, expected {expect}")
    return launches


def family_variant(base, family):
    """The vlm and encdec variants of a reduced config (no registered arch
    has either family): 8 stub vision tokens; a whisper-like 2-layer
    encoder over 16 stub frames with sinusoidal positions."""
    if family == "vlm":
        return dataclasses.replace(base, family="vlm", n_vision_tokens=8)
    return dataclasses.replace(base, family="encdec", n_enc_layers=2,
                               enc_seq=16, rope_theta=0.0, norm="layernorm",
                               act="gelu")


def fp32_config(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def lm_batch_on(cfg, rng, batch, seq, dev):
    """Tokens and labels from ``synthetic_lm_batch``, plus stub vision
    embeds (vlm) or frames (encdec), on ``dev``."""
    toks, labels = synthetic_lm_batch(rng, batch, seq, cfg.vocab_size)
    b = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if cfg.family == "vlm":
        b["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        b["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return tree_map(lambda t: t.to(dev), b)


@contextlib.contextmanager
def captured_logits():
    """Record the fp32 masked logits of every greedy read-out
    (``layers.lm_head_logits``) inside the block."""
    seen, orig = [], LMLAYERS.lm_head_logits

    def keep(cfg, p, x, ax=LMLAYERS.UNSHARDED):
        seen.append(LMLAYERS._masked_logits(cfg, p, x, ax))
        return orig(cfg, p, x, ax)

    LMLAYERS.lm_head_logits = keep
    try:
        yield seen
    finally:
        LMLAYERS.lm_head_logits = orig


def flash_launches():
    """{stage: (all launches, tensor-core launches)} so far."""
    return {n: (KERNELS[n]["fn"].launches, KERNELS[n]["fn"].tc_launches)
            for n in FLASH_STAGES}


def flash_delta(before):
    now = flash_launches()
    return {n: now[n][0] - before[n][0] for n in FLASH_STAGES}, \
        {n: now[n][1] - before[n][1] for n in FLASH_STAGES}


def attention_layers(cfg):
    """Attention calls of one forward: (frozen ones, adaptive ones)."""
    n_ad = cfg.n_adaptive_layers
    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "hybrid":
        return 0, cfg.n_layers // cfg.attn_every
    if cfg.family == "encdec":       # encoder; self + cross a decoder layer
        return cfg.n_enc_layers + 2 * (cfg.n_layers - n_ad), 2 * n_ad
    return cfg.n_layers - n_ad, n_ad


def expected_flash(cfg, *, train):
    """Flash launches of one forward (``train=False``: no gradients, every
    attention the forward alone) or one split train step (the frozen
    calls the forward alone, the adaptive ones forward + lse, dQ, dK/dV)."""
    frozen, adaptive = attention_layers(cfg)
    if not train:
        frozen, adaptive = frozen + adaptive, 0
    return {"flash_attention_fwd": frozen,
            "flash_attention_fwd_lse": adaptive,
            "flash_attention_dq": adaptive, "flash_attention_dkv": adaptive}


def decode_run(cfg, params, batch, *, cache_dtype, slots, enc_len=None):
    """Feed ``batch``'s tokens one by one through ``decode_step`` from an
    empty cache -> (B, S) predicted next tokens."""
    toks = batch["tokens"]
    B, S = toks.shape
    cache = lm.init_cache(cfg, B, slots, enc_seq=cfg.enc_seq,
                          dtype=cache_dtype, device=toks.device)
    if cfg.family == "encdec":
        cache, _ = lm.prefill_cross_cache(cfg, params, batch["frames"], cache)
    preds = []
    for t in range(S):
        nxt, cache = lm.decode_step(cfg, params, cache, toks[:, t:t + 1], t,
                                    enc_len=enc_len)
        preds.append(nxt)
    return torch.cat(preds, 1)


def forward_argmax(cfg, params, batch):
    """The teacher-forced forward's greedy tokens (vlm: past its vision
    tokens) and their fp32 logits."""
    x, _ = lm.forward(cfg, params, batch)
    if cfg.family == "vlm":
        x = x[:, cfg.n_vision_tokens:]
    return (LMLAYERS.lm_head_logits(cfg, params["head"], x)[0],
            LMLAYERS._masked_logits(cfg, params["head"], x,
                                    LMLAYERS.UNSHARDED))


def decode_gate(cfg, params, batch, cache_dtype):
    """The reference's decode-equals-forward gate on the card: the share of
    greedy decode tokens equal to the forward's argmax, and the flash
    launches of the forward (decode launches none)."""
    with torch.no_grad():
        before = flash_launches()
        want, _ = forward_argmax(cfg, params, batch)
        launches, tc = flash_delta(before)
        got = decode_run(cfg, params, batch, cache_dtype=cache_dtype,
                         slots=batch["tokens"].shape[1] + 1,
                         enc_len=cfg.enc_seq or None)
        decode_launches, _ = flash_delta(before)
    return float((got == want).float().mean()), launches, tc, \
        decode_launches == launches


def randomized_cache(cfg, batch, slots, dtype, dev, gen):
    """A cache of random values (attention k / v N(0, 1), int8 codes
    uniform in [-127, 127] with scales in (0, 0.02], recurrent states
    N(0, 0.1)): the timed steps read it; no token is checked there."""
    cache = lm.init_cache(cfg, batch, slots, dtype=dtype, device=dev)
    for leaf in tree_leaves(cache):
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen,
                                     device=dev, dtype=torch.int8))
        elif leaf.dtype == torch.bfloat16 and leaf.dim() == 5:
            leaf.normal_(generator=gen)
        elif leaf.dtype == torch.bfloat16:          # int8 scales
            leaf.uniform_(1e-4, 0.02, generator=gen)
        else:
            leaf.normal_(0.0, 0.1, generator=gen)
    return cache


def timed_decode(cfg, params, cache, pos, *, window=0, ring=False):
    """Median device ms of a ``decode_step`` at ``pos`` (CUDA events,
    ``DECODE_WARMUP`` warm-up steps then ``DECODE_TIMED``), with the
    tokens/s it gives."""
    B = tree_leaves(cache)[0].shape[1]
    tok = torch.ones((B, 1), dtype=torch.int32, device=tree_leaves(
        cache)[0].device)
    ms = []
    with torch.no_grad():
        for i in range(DECODE_WARMUP + DECODE_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lm.decode_step(cfg, params, cache, tok, pos, window=window,
                           ring=ring)
            end.record()
            end.synchronize()
            if i >= DECODE_WARMUP:
                ms.append(start.elapsed_time(end))
    med = float(np.median(ms))
    return {"median_ms": med, "ms": ms, "tokens_per_s": B / (med / 1e3)}


@contextlib.contextmanager
def routed_experts():
    """Record the (tokens, top_k) expert ids of every ``moe_block`` call
    (one a MoE layer) inside the block."""
    seen, orig = [], MOEM.top_k_lowest

    def keep(x, k):
        vals, idx = orig(x, k)
        seen.append(idx)
        return vals, idx

    MOEM.top_k_lowest = keep
    try:
        yield seen
    finally:
        MOEM.top_k_lowest = orig


def decode_bytes(params, cache, routed=None):
    """Bytes a decode step must read: every weight but the embedding
    table (a row of it), of the experts only those that ``routed`` (each
    MoE layer's expert ids in the step) names, once each; and the whole
    cache (its KV, scales and states once)."""
    w = experts = 0
    for path, t in zip(leaf_paths(params), tree_leaves(params)):
        b = t.numel() * t.element_size()
        if path[-2:] in (("moe", "wi"), ("moe", "wg"), ("moe", "wo")):
            experts += b
            n_experts = t.shape[-3]
        else:
            w += b
    table = params["embed"]["table"]
    w -= table.numel() * table.element_size()
    if experts and routed is not None:      # each layer's share of experts
        used = sum(len(torch.unique(idx)) for idx in routed)
        experts = experts * used / (len(routed) * n_experts)
    return w + experts, sum(t.numel() * t.element_size()
                            for t in tree_leaves(cache))


def device_profile(fn):
    """``fn()`` once under torch.profiler: device ms by kernel group
    (``LM_KERNEL_GROUPS``), the top kernels and the device's idle share of
    the window (an upper bound: the profiler slows the host)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_group, by_name = {}, {}
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for e in on_card:
        us = e.time_range.elapsed_us()
        group = next((g for g, keys in LM_KERNEL_GROUPS
                      if any(k in e.name for k in keys)), "other")
        by_group[group] = by_group.get(group, 0.0) + us / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    busy = sum(by_group.values())
    return {"window_ms": window_ms, "device_events": len(on_card),
            "device_busy_ms": busy if on_card else None,
            "device_idle_share": (1.0 - busy / window_ms) if on_card
            else None, "device_ms_by_group": by_group,
            "top_device_ms": [[n[:70], ms] for n, ms in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:8]]}


def phase_lm_decode(dev, card, peak):
    """Decode serving of qwen1.5-0.5b (``serve_lm``'s default arch) at full
    width: the reference's decode-equals-forward gate in fp32 params (B 4
    x S 64, fp32 and int8 caches, >= 0.95), the same run in bf16 (the
    agreement and the decode-vs-forward logits' relative L2),
    ``serve_lm.main --full-model`` (B 4, prompt 16, gen 32), then timed
    steps beside their bounds: decode_32k's cache (32768 slots, B 8, bf16
    and int8) and long_500k's ring (B 1, window 8192, pos 524287), and a
    profile of the bf16 32k step. Returns (the path's launches, (config,
    the bf16 params, the gate batch))."""
    t_phase = time.perf_counter()
    zero_counts()
    cfg = get_config(DECODE_ARCH)
    cfg32 = fp32_config(cfg)
    batch = lm_batch_on(cfg, np.random.default_rng(SEED), DECODE_GATE_BATCH,
                        DECODE_GATE_SEQ, dev)
    params = lm.init_params(cfg32, torch.Generator(device=dev).manual_seed(
        SEED))
    gate = {}
    for name, dt in (("fp32_cache", torch.float32), ("int8_cache",
                                                     torch.int8)):
        agree, fwd, fwd_tc, dec_none = decode_gate(cfg32, params, batch, dt)
        gate[name] = {"agreement": agree, "forward_launches": fwd,
                      "forward_tc_launches": fwd_tc}
        check(agree >= DECODE_GATE, f"lm_decode fp32 params, {name}: "
              f"decode/forward agreement {agree} < {DECODE_GATE}")
        check(fwd == expected_flash(cfg32, train=False) and dec_none
              and not any(fwd_tc.values()),
              f"lm_decode {name}: flash launches {fwd} (tc {fwd_tc}), "
              f"decode added none: {dec_none}")
    del params
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    with torch.no_grad():
        before = flash_launches()
        want, fwd_logits = forward_argmax(cfg, params, batch)
        fwd16, fwd16_tc = flash_delta(before)
        with captured_logits() as seen:
            got = decode_run(cfg, params, batch, cache_dtype=torch.bfloat16,
                             slots=DECODE_GATE_SEQ + 1)
        dec_logits = torch.cat(seen, 1)
    # over the true vocab (the padding columns sit at -1e30 on both sides)
    dec_logits, fwd_logits = (t[..., :cfg.vocab_size]
                              for t in (dec_logits, fwd_logits))
    rel = float(torch.linalg.vector_norm(dec_logits - fwd_logits)
                / torch.linalg.vector_norm(fwd_logits))
    bf16 = {"agreement": float((got == want).float().mean()),
            "logits_rel_l2": rel, "forward_launches": fwd16,
            "forward_tc_launches": fwd16_tc}
    del dec_logits, fwd_logits, seen
    check(fwd16 == fwd16_tc == expected_flash(cfg, train=False),
          f"lm_decode bf16 forward: flash launches {fwd16} (tc {fwd16_tc})")
    check(np.isfinite(rel) and rel <= DECODE_BF16_REL_L2,
          f"lm_decode bf16: logits relative L2 {rel} > {DECODE_BF16_REL_L2}")

    before = flash_launches()
    t0 = time.perf_counter()
    served = serve_lm.main(["--full-model", "--batch", "4", "--prompt-len",
                            "16", "--gen", "32"])
    serve_s = time.perf_counter() - t0
    check(served.shape == (4, 32) and served.min() >= 0
          and served.max() < cfg.vocab_size,
          f"lm_decode serve_lm: tokens {served.shape} in "
          f"[{served.min()}, {served.max()}]")
    check(flash_delta(before)[0] == dict.fromkeys(FLASH_STAGES, 0),
          "lm_decode: serve_lm's decode launched a flash kernel")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    timed, profile_row = {}, None
    seq32k = get_shape("decode_32k").seq_len
    for name, dt, B, slots, pos, kw in (
            ("decode_32k_bf16", torch.bfloat16, DECODE_32K_BATCH, seq32k,
             seq32k - 1, {}),
            ("decode_32k_int8", torch.int8, DECODE_32K_BATCH, seq32k,
             seq32k - 1, {}),
            ("long_500k_ring_bf16", torch.bfloat16, 1, DECODE_RING_WINDOW,
             DECODE_RING_POS, dict(window=DECODE_RING_WINDOW, ring=True))):
        torch.cuda.empty_cache()
        cache = randomized_cache(cfg, B, slots, dt, dev, gen)
        torch.cuda.reset_peak_memory_stats(dev)
        row = timed_decode(cfg, params, cache, pos, **kw)
        wb, cb = decode_bytes(params, cache)
        b = bound(wb + cb, 0.0, peak)
        row.update(batch=B, cache_slots=slots, pos=pos, cache_dtype=str(dt),
                   weight_bytes=wb, cache_bytes=cb, bound_ms=b[0],
                   bound_share=b[0] / row["median_ms"],
                   peak_mem_bytes=torch.cuda.max_memory_allocated(dev))
        timed[name] = row
        if name == "decode_32k_bf16":
            tok = torch.ones((B, 1), dtype=torch.int32, device=dev)
            with torch.no_grad():
                profile_row = device_profile(lambda: lm.decode_step(
                    cfg, params, cache, tok, pos))
        del cache
    torch.cuda.empty_cache()
    launches = {n: KERNELS[n]["fn"].launches for n in KERNELS}
    emit({"phase": "lm_decode", "card": card, "arch": DECODE_ARCH,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": [cfg.n_heads, cfg.n_kv_heads], "vocab": cfg.vocab_size,
          "params": sum(t.numel() for t in tree_leaves(params)),
          "gate_batch": [DECODE_GATE_BATCH, DECODE_GATE_SEQ],
          "fp32_gate": gate, "bf16": bf16,
          "bf16_rel_l2_bar": DECODE_BF16_REL_L2,
          "serve_lm": {"argv": "--full-model --batch 4 --prompt-len 16 "
                               "--gen 32", "seconds": serve_s,
                       "sample": served[0][:8].tolist()},
          "timed": timed, "decode_32k_bf16_profile": profile_row,
          "launches": {n: launches[n] for n in FLASH_STAGES},
          "phase_s": time.perf_counter() - t_phase})
    return launches, (cfg, params, batch)


# ---------------------------------------------------------------------------
# lm_scaleout: the LM's sharded steps on a world of one
# ---------------------------------------------------------------------------

SCALEOUT_REL_L2 = 1e-3      # where a leaf is not bit for bit
SCALEOUT_DECODE_STEPS = 8


def leaf_compare(got, want):
    """{leaf: [bit for bit, relative L2]} over two trees."""
    return {"/".join(map(str, p)): [bool(torch.equal(a, b)), float(
        torch.linalg.vector_norm(a.float() - b.float()) / max(float(
            torch.linalg.vector_norm(b.float())), 1e-30))]
        for p, a, b in zip(leaf_paths(want), tree_leaves(got),
                           tree_leaves(want))}


def sgd_read(old, new):
    """One SGD(lr = 1) step's gradient, read as old - new per leaf."""
    return tree_map(lambda a, b: a - b, old, new)


def timed_steps(run, n=LM_STEPS):
    """``run()`` n times (the first a warm-up), each timed by CUDA events
    -> (ms of each, the first call's result)."""
    ms, first = [], None
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        first = out if i == 0 else first
        del out
    return ms, first


def scaleout_train(cfg, st, batch, mesh, layout):
    """One layout's sharded split step against lm_train's unsharded one
    from the same state, both as SGD(lr = 1) steps: the first step's loss
    and gradient (old - new; the unsharded TP reference is the unclipped
    gradient, as no step clips under TP, the dp layout's the clipped
    step), each timed 1 + 3 steps (CUDA events), the sharded one's flash
    launches each step."""
    shape = ShapeConfig("lm_train", LM_SEQ, LM_BATCH, "train")
    opt = sgd(1.0)
    step, _, specs = STEPS.build_train_step(cfg, mesh, shape,
                                            multi_pod=False, layout=layout,
                                            optimizer=opt, tie_lambda=LM_TIE)
    args = [SH.shard_tree(a, s, mesh) for a, s in zip(
        (st.frozen, st.B, st.trainable, init_opt_state(opt, st.trainable),
         batch), specs)]
    per_step = []

    def sharded():
        before = flash_launches()
        new, _, m = step(*args)
        per_step.append(flash_delta(before)[1])
        return new, m["loss"]

    def unsharded():
        if layout == "dp":
            new, _, m = make_train_step(cfg, optimizer=opt,
                                        tie_lambda=LM_TIE)(
                st.frozen, st.B, st.trainable,
                init_opt_state(opt, st.trainable), batch)
            return new, m["loss"]
        (loss, _, _), g = adaptive_loss_and_grads(
            cfg, st.frozen, st.B, st.trainable, batch, tie_lambda=LM_TIE)
        return apply_updates(st.trainable, opt.update(g, {})[0]), loss

    ms, (new, loss) = timed_steps(sharded)
    got = sgd_read(st.trainable, SH.gather_tree(new, step.out_specs[0], mesh))
    loss = float(loss)
    del new
    ums, (new, want_loss) = timed_steps(unsharded)
    want, want_loss = sgd_read(st.trainable, new), float(want_loss)
    del new
    by_leaf = leaf_compare(got, want)
    del got, want
    return {"loss": [loss, want_loss], "loss_bit_equal": loss == want_loss,
            "grad_leaves_bit_equal": all(b for b, _ in by_leaf.values()),
            "grad_rel_l2_worst": max(r for _, r in by_leaf.values()),
            "grad_by_leaf": by_leaf, "step_ms": ms,
            "median_step_ms": float(np.median(ms[1:])),
            "unsharded_step_ms": ums,
            "unsharded_median_step_ms": float(np.median(ums[1:])),
            "flash_launches_per_step": per_step}


DECODE_CACHES = (("bf16", torch.bfloat16), ("int8", torch.int8))


def unsharded_decode(cfg, params, batch):
    """The unsharded path at the gate batch: the forward's next token, and
    for each cache dtype ``SCALEOUT_DECODE_STEPS`` decode steps' tokens and
    final cache."""
    B, S = batch["tokens"].shape
    with torch.no_grad():
        x, _ = lm.forward(cfg, params, {"tokens": batch["tokens"]})
        out = {"prefill": LMLAYERS.lm_head_logits(
            cfg, params["head"], x[:, -1:])[0].to(torch.int32)}
        for name, dt in DECODE_CACHES:
            cache = lm.init_cache(cfg, B, S, dtype=dt, device=dev_of(params))
            toks, ms = [], []
            for t in range(SCALEOUT_DECODE_STEPS):
                t0 = time.perf_counter()
                n, cache = lm.decode_step(cfg, params, cache,
                                          batch["tokens"][:, t:t + 1], t)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                toks.append(n)
            out[name] = (torch.cat(toks, 1), cache, ms)
    return out


def scaleout_decode(cfg, params, batch, mesh, want, *, fsdp):
    """``build_prefill_step`` then ``SCALEOUT_DECODE_STEPS`` steps of
    ``build_decode_step`` (bf16 and int8 caches; FSDP with
    weight-stationary decode when ``fsdp``) against ``want``, the
    unsharded path's (``unsharded_decode``): tokens, then each cache leaf
    bit for bit or its max abs difference, and each decode step's host
    ms (the call to its device sync) beside the unsharded step's."""
    cfg = dataclasses.replace(cfg, fsdp=fsdp)
    B, S = batch["tokens"].shape
    prefill, _, pspecs = STEPS.build_prefill_step(
        cfg, mesh, ShapeConfig("gate", S, B, "prefill"), multi_pod=False)
    tok = prefill(*[SH.shard_tree(a, s, mesh) for a, s in zip(
        (params, {"tokens": batch["tokens"]}), pspecs)])
    out = {"prefill_tokens_equal": bool(torch.equal(
        SH.gather_tree(tok, prefill.out_specs, mesh), want["prefill"]))}
    for name, dt in DECODE_CACHES:
        step, args, specs = STEPS.build_decode_step(
            cfg, mesh, ShapeConfig("gate", S, B, "decode"), multi_pod=False,
            weight_stationary=fsdp, kv_dtype=dt)
        cache = SH.shard_tree(tree_map(lambda t: torch.zeros(
            t.shape, dtype=t.dtype, device=dev_of(params)), args[1]),
            specs[1], mesh)
        p = SH.shard_tree(params, specs[0], mesh)
        got, ms = [], []
        for t in range(SCALEOUT_DECODE_STEPS):
            tk = SH.shard_tree(batch["tokens"][:, t:t + 1], specs[2], mesh)
            t0 = time.perf_counter()
            n, cache = step(p, cache, tk, t)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            got.append(SH.gather_tree(n, step.out_specs[0], mesh))
        gc = SH.gather_tree(cache, step.out_specs[1], mesh)
        want_tok, want_cache, want_ms = want[name]
        by_leaf = {"/".join(k): [bool(torch.equal(a, b)), float(
            (a.float() - b.float()).abs().max())] for k, a, b in zip(
            leaf_paths(want_cache), tree_leaves(gc), tree_leaves(want_cache))}
        out[name] = {"tokens_equal": bool(torch.equal(torch.cat(got, 1),
                                                      want_tok)),
                     "cache_bit_equal": all(b for b, _ in by_leaf.values()),
                     "cache_max_abs_diff": max(d for _, d in
                                               by_leaf.values()),
                     "step_host_ms": ms,
                     "median_step_host_ms": float(np.median(ms[1:])),
                     "unsharded_step_host_ms": want_ms,
                     "unsharded_median_step_host_ms": float(
                         np.median(want_ms[1:]))}
        del cache, gc
    return out


def dev_of(tree):
    return tree_leaves(tree)[0].device


def phase_lm_scaleout(dev, card, train_ctx, decode_ctx):
    """The LM's sharded steps (``launch/steps.py``) on a world of one over
    NCCL, on the models lm_train and lm_decode hold (no new model):
    qwen3-1.7b's split step at lm_train's state and batch, layouts "tp"
    and "dp", against lm_train's unsharded step; qwen1.5-0.5b's prefill
    and decode at lm_decode's gate shape, plain and with FSDP +
    weight-stationary decode, against the unsharded path. Returns the
    path's launches."""
    t_phase = time.perf_counter()
    cfg, st, batch, lm_train_ms = train_ctx
    dcfg, dparams, dbatch = decode_ctx
    zero_counts()
    seconds = {}
    t0 = time.perf_counter()
    with SH.engine_world(dev):
        with make_production_mesh(model=1, device=dev) as mesh:
            seconds["world"] = time.perf_counter() - t0
            train = {}
            for layout in ("tp", "dp"):
                t0 = time.perf_counter()
                train[layout] = scaleout_train(cfg, st, batch, mesh, layout)
                seconds[f"train_{layout}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = unsharded_decode(dcfg, dparams, dbatch)
            seconds["decode_unsharded"] = time.perf_counter() - t0
            decode = {}
            for kind, fsdp in (("plain", False),
                               ("fsdp_weight_stationary", True)):
                t0 = time.perf_counter()
                decode[kind] = scaleout_decode(dcfg, dparams, dbatch, mesh,
                                               want, fsdp=fsdp)
                seconds[f"decode_{kind}"] = time.perf_counter() - t0
            del want
            mesh_shape = dict(mesh.shape)
    launches = counts()
    n_trunk = cfg.n_layers - cfg.n_adaptive_layers
    expect_step = {"flash_attention_fwd": n_trunk,
                   "flash_attention_fwd_lse": cfg.n_adaptive_layers,
                   "flash_attention_dq": cfg.n_adaptive_layers,
                   "flash_attention_dkv": cfg.n_adaptive_layers}
    emit({"phase": "lm_scaleout", "card": card, "world": 1,
          "mesh": mesh_shape, "train_arch": LM_ARCH,
          "train_batch": [LM_BATCH, LM_SEQ],
          "lm_train_median_step_ms": lm_train_ms, "train": train,
          "decode_arch": DECODE_ARCH,
          "decode_batch": list(dbatch["tokens"].shape),
          "decode_steps": SCALEOUT_DECODE_STEPS, "decode": decode,
          "launches": {n: launches[n] for n in FLASH_STAGES
                       + ("adaptive_combine",)},
          "seconds": seconds, "phase_s": time.perf_counter() - t_phase})
    for layout, r in train.items():
        got, want = r["loss"]
        check(np.isfinite(got) and abs(got - want) <= SCALEOUT_REL_L2
              * abs(want), f"lm_scaleout {layout}: loss {r['loss']}")
        check(r["grad_rel_l2_worst"] <= SCALEOUT_REL_L2,
              f"lm_scaleout {layout}: worst gradient leaf's relative L2 "
              f"{r['grad_rel_l2_worst']}")
        check(all(p == expect_step for p in r["flash_launches_per_step"]),
              f"lm_scaleout {layout}: tensor-core flash launches a step "
              f"{r['flash_launches_per_step']}, expected {expect_step}")
    for kind, r in decode.items():
        check(r["prefill_tokens_equal"], f"lm_scaleout {kind}: prefill tokens")
        for name in ("bf16", "int8"):
            check(r[name]["tokens_equal"],
                  f"lm_scaleout {kind} {name}: decode tokens differ")
            check(r[name]["cache_bit_equal"],
                  f"lm_scaleout {kind} {name}: cache {r[name]}")
    return launches


def family_config(arch):
    """A family's full-width config; the MoE cut to 2 trunk + 1 adaptive
    layers."""
    cfg = get_config(arch)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_MOE_LAYERS)
    return cfg


def recurrence_ms(cfg, dev, gen, B, S):
    """Device ms of the family's plain time loop at (B, S): rwkv's WKV or
    mamba's selective scan, on random fp32 operands."""
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    if cfg.family == "ssm":
        nh, hs = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
        w = torch.rand((B, S, nh, hs), generator=gen, device=dev)
        args = (rnd(B, S, nh, hs), rnd(B, S, nh, hs), rnd(B, S, nh, hs), w,
                rnd(nh, hs), torch.zeros((B, nh, hs, hs), device=dev))
        return time_ms(lambda: RWKVM.wkv_recurrence(*args))
    nh, hd, ds = cfg.d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim, \
        cfg.ssm_state
    args = (rnd(B, S, nh, hd), rnd(B, S, ds), rnd(B, S, ds),
            torch.rand((B, S, nh), generator=gen, device=dev),
            torch.rand((B, S, nh), generator=gen, device=dev),
            torch.zeros((B, nh, hd, ds), device=dev))
    return time_ms(lambda: SSMM.ssm_recurrence(*args))


def family_train_step(cfg, dev):
    """One split train step at full width (bf16, seed-0 weights, B 2 x S
    32): its loss, whether the trainable tree changed, its flash launches
    and its ms."""
    st = init_train_state(cfg, torch.Generator(device=dev).manual_seed(SEED))
    batch = lm_batch_on(cfg, np.random.default_rng(SEED), FAMILY_TRAIN_BATCH,
                        FAMILY_TRAIN_SEQ, dev)
    step = make_train_step(cfg, tie_lambda=LM_TIE)
    before = flash_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    tr, _, m = step(st.frozen, st.B, st.trainable, st.opt_state, batch)
    end.record()
    end.synchronize()
    launches, tc = flash_delta(before)
    changed = any(bool((a != b).any()) for a, b in zip(
        tree_leaves(tr), tree_leaves(st.trainable)))
    return {"loss": float(m["loss"]), "trainable_changed": changed,
            "step_ms": start.elapsed_time(end), "launches": launches,
            "tc_launches": tc}


def reduced_family_steps(dev):
    """Every registered arch reduced, plus the vlm and encdec variants:
    ``FAMILY_RED_STEPS`` split train steps (fp32, the FMA kernels) on the
    card and on the CPU from the same weights and batches -> {name: row}
    with per-step |delta loss| and the card's flash launches a step."""
    cfgs = [get_config(a).reduced() for a in ARCH_IDS]
    base = get_config(DECODE_ARCH).reduced()
    cfgs += [family_variant(base, "vlm"), family_variant(base, "encdec")]
    rows = {}
    for cfg in cfgs:
        name = cfg.name if cfg.family not in ("vlm", "encdec") else \
            f"{cfg.family}-reduced"
        params = lm.init_params(cfg, torch.Generator().manual_seed(SEED))
        rng = np.random.default_rng(SEED)
        host = [lm_batch_on(cfg, rng, FAMILY_RED_BATCH, FAMILY_RED_SEQ, "cpu")
                for _ in range(FAMILY_RED_STEPS)]

        def run(device):
            st = train_state_from_params(
                cfg, tree_map(lambda t: t.to(device), params))
            step = make_train_step(cfg, tie_lambda=LM_TIE)
            tr, os_, losses, per_step = st.trainable, st.opt_state, [], []
            for b in host:
                before = flash_launches()
                tr, os_, m = step(st.frozen, st.B, tr, os_,
                                  tree_map(lambda t: t.to(device), b))
                losses.append(float(m["loss"]))
                per_step.append(flash_delta(before))
            return losses, per_step

        card_losses, per_step = run(dev)
        cpu_losses, _ = run("cpu")
        deltas = [abs(a - b) for a, b in zip(card_losses, cpu_losses)]
        want = expected_flash(cfg, train=True)
        rows[name] = {"family": cfg.family, "card_losses": card_losses,
                      "cpu_losses": cpu_losses, "max_step_delta": max(deltas),
                      "launches_per_step": per_step[0][0]}
        check(max(deltas) <= FAMILY_RED_TOL,
              f"lm_families reduced {name}: card vs CPU step deltas {deltas}")
        check(all(a == want and not any(tc.values()) for a, tc in per_step),
              f"lm_families reduced {name}: flash launches a step "
              f"{per_step}, expected {want} on the FMA kernels")
    return rows


def phase_lm_families(dev, card, peak):
    """The LM zoo at full width on the card: rwkv6-1.6b and zamba2-2.7b
    whole, qwen3-moe-235b-a22b cut to 2 trunk + 1 adaptive layers. Each:
    the decode-equals-forward gate in fp32 params (B 2 x S 32, >= 0.95), a
    bf16 decode step's ms at B 8 (a 4096-slot cache; rwkv its O(1) state)
    and its bound, the time loop's ms (rwkv, mamba); rwkv6 and zamba2 one
    full-width split train step (finite loss, trainable tree changed).
    Then every registered arch reduced, with the vlm and encdec variants:
    split train steps card vs CPU within 1e-4. Flash launches checked a
    forward and a step. Returns the path's launches."""
    t_phase = time.perf_counter()
    zero_counts()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}
    for arch in FAMILY_ARCHS:
        cfg = family_config(arch)
        cfg32 = fp32_config(cfg)
        batch = lm_batch_on(cfg, np.random.default_rng(SEED),
                            FAMILY_GATE_BATCH, FAMILY_GATE_SEQ, dev)
        t0 = time.perf_counter()
        params = lm.init_params(cfg32, torch.Generator(
            device=dev).manual_seed(SEED))
        agree, fwd, fwd_tc, dec_none = decode_gate(cfg32, params, batch,
                                                   torch.float32)
        gate_s = time.perf_counter() - t0
        check(agree >= DECODE_GATE, f"lm_families {arch}: fp32 decode/"
              f"forward agreement {agree} < {DECODE_GATE}")
        check(fwd == expected_flash(cfg32, train=False) and dec_none
              and not any(fwd_tc.values()),
              f"lm_families {arch}: forward flash launches {fwd} (tc "
              f"{fwd_tc}), decode added none: {dec_none}")
        del params
        torch.cuda.empty_cache()
        params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED))
        cache = randomized_cache(cfg, FAMILY_DECODE_BATCH,
                                 FAMILY_DECODE_SLOTS, torch.bfloat16, dev,
                                 gen)
        before = flash_launches()
        step = timed_decode(cfg, params, cache, FAMILY_DECODE_SLOTS - 1)
        check(flash_delta(before)[0] == dict.fromkeys(FLASH_STAGES, 0),
              f"lm_families {arch}: decode launched a flash kernel")
        # the timed step once more, its routing recorded (MoE: the bound
        # reads the routed experts alone)
        tok = torch.ones((FAMILY_DECODE_BATCH, 1), dtype=torch.int32,
                         device=dev)
        with torch.no_grad(), routed_experts() as routed:
            lm.decode_step(cfg, params, cache, tok, FAMILY_DECODE_SLOTS - 1)
        wb, cb = decode_bytes(params, cache, routed)
        b = bound(wb + cb, 0.0, peak)
        step.update(weight_bytes=wb, cache_bytes=cb, bound_ms=b[0],
                    bound_share=b[0] / step["median_ms"])
        if routed:
            step["routed_experts_by_layer"] = [len(torch.unique(idx))
                                               for idx in routed]
        del routed
        del cache
        row = {"family": cfg.family, "layers": cfg.n_layers,
               "d_model": cfg.d_model,
               "params": sum(t.numel() for t in tree_leaves(params)),
               "fp32_gate": {"agreement": agree, "forward_launches": fwd,
                             "seconds": gate_s},
               "decode_step": step}
        del params
        torch.cuda.empty_cache()
        if cfg.family in ("ssm", "hybrid"):
            row["recurrence_ms"] = {
                f"B{B}xS{S}": recurrence_ms(cfg, dev, gen, B, S)
                for B, S in ((FAMILY_GATE_BATCH, FAMILY_GATE_SEQ),
                             (FAMILY_DECODE_BATCH, 1))}
            tr = family_train_step(cfg, dev)
            row["train_step"] = tr
            check(np.isfinite(tr["loss"]) and tr["trainable_changed"],
                  f"lm_families {arch}: train step {tr}")
            want = expected_flash(cfg, train=True)
            check(tr["launches"] == want == tr["tc_launches"],
                  f"lm_families {arch}: train step flash launches "
                  f"{tr['launches']} (tc {tr['tc_launches']}), expected "
                  f"{want} on the tensor cores")
            torch.cuda.empty_cache()
        rows[arch] = row
    reduced = reduced_family_steps(dev)
    launches = {n: KERNELS[n]["fn"].launches for n in KERNELS}
    emit({"phase": "lm_families", "card": card, "archs": rows,
          "moe_cut": f"{FAMILY_MOE_LAYERS} of "
                     f"{get_config('qwen3-moe-235b-a22b').n_layers} layers",
          "reduced_train_steps": reduced,
          "launches": {n: launches[n] for n in FLASH_STAGES},
          "phase_s": time.perf_counter() - t_phase})
    return launches


# the groups of phases ``--only`` selects, in the order main runs them,
# and the groups each needs first
ONLY_GROUPS = ("kernels", "serve", "rounds", "lm_train", "lm_decode",
               "lm_scaleout", "lm_families")
ONLY_NEEDS = {"lm_scaleout": ("lm_train", "lm_decode")}


def selected_groups(argv):
    """The groups of phases to run: all of them, or ``--only a,b`` and
    those they need."""
    import argparse
    ap = argparse.ArgumentParser(description="On-card smoke of the port.")
    ap.add_argument("--only", default="",
                    help="comma-separated groups of phases: "
                    + ", ".join(ONLY_GROUPS))
    names = [n for n in ap.parse_args(argv).only.split(",") if n]
    unknown = sorted(set(names) - set(ONLY_GROUPS))
    if unknown:
        ap.error(f"unknown groups {unknown}; choose from {ONLY_GROUPS}")
    if not names:
        return set(ONLY_GROUPS)
    return set(names).union(*(ONLY_NEEDS.get(n, ()) for n in names))


def main():
    t_start = time.perf_counter()
    groups = selected_groups(sys.argv[1:])
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a card")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = f"{kind} ({smi})"
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # launch.dryrun is host work: it runs beside the card phases
    dryrun = start_dryrun() if "lm_train" in groups else None
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": str(_build.build_dir().relative_to(ROOT)),
          "nvcc_s_by_source": _build.build_seconds})

    rows = phase_kernels(dev, peaks(kind), card) if "kernels" in groups \
        else None
    launches, path_errs = {}, {}

    def fold(errs):
        for name, err in errs.items():
            path_errs[name] = max(path_errs.get(name, 0.0), err)

    if "serve" in groups:
        # path 1: serving (counts zeroed just before, read just after)
        zero_counts()
        served = {"int8": phase_serve("int8", G_INT8, dev, card),
                  "fp32": phase_serve("fp32", G_FP32, dev, card)}
        launches["serve"] = {name: spec["fn"].launches
                             for name, spec in KERNELS.items()}
        phase_parity(served, dev, card,
                     {name: n for name, n in launches["serve"].items()
                      if "serve" in KERNELS[name]["paths"]})
        phase_breakdown(served, card)

        # path 2: IVF shortlist serving (counts zeroed just before, read
        # just after)
        zero_counts()
        with last_operands(IVF_OPS, by_reference=IVF_OPS) as seen:
            ivf = phase_serve("ivf", G_INT8, dev, card)
        launches["serve_ivf"] = {name: spec["fn"].launches
                                 for name, spec in KERNELS.items()}
        fold(ivf_path_errs(seen))
        del seen
        phase_serve_ivf_checks(ivf, served["int8"][5], dev, card)
        phase_breakdown({"ivf": ivf}, card)
        del ivf, served
        torch.cuda.empty_cache()

    if "rounds" in groups:
        # path 3: the federated round (counts zeroed inside, just before)
        launches["round_fedstil"], errs, (strat, res) = phase_round_fedstil(
            dev, card)
        fold(errs)
        phase_serve_round_heads(strat, res, dev, card)
        # path 4: the round with the wire codec (counts zeroed inside)
        launches["round_fedstil_codec"], errs = phase_round_fedstil_codec(
            dev, card, res)
        fold(errs)
        # path 5: the round on the host engine (counts zeroed inside), then
        # the slice's other host and codec paths, shorter
        launches["round_fedstil_host"], errs = phase_round_fedstil_host(
            dev, card, (strat, res))
        fold(errs)
        phase_round_host_variants(dev, card)
        # path 6: the round with the topk+int8 wire codec (counts zeroed
        # inside)
        launches["round_fedstil_codec_int8"], errs, res_int8 = \
            phase_round_fedstil_codec_int8(dev, card, res)
        fold(errs)
        # path 7: the Table II strategy zoo (counts zeroed inside)
        launches["round_zoo"], errs = phase_round_zoo(dev, card)
        fold(errs)
        # path 8: the sharded engine on a world of one (counts zeroed
        # inside)
        launches["round_sharded"], errs = phase_round_sharded(
            dev, card, (strat, res), res_int8, launches["round_fedstil"])
        fold(errs)
        del res_int8, strat, res
        phase_round_profile(dev, card)
        phase_server_scale(dev, card)
        codec_peaks = phase_wire_round_scale(dev, card)
        torch.cuda.empty_cache()
        phase_telemetry(dev, card, codec_peaks)
    if "lm_train" in groups:
        # path 8: the dense LM's edge train step (counts zeroed inside)
        launches["lm_train"], errs, train_ctx = phase_lm_train(dev, card)
        fold(errs)
        torch.cuda.empty_cache()
        # path 8b: the same step priced against the roofline (counts zeroed
        # inside)
        launches["lm_roofline"] = phase_lm_roofline(dev, card, train_ctx,
                                                    dryrun)
        torch.cuda.empty_cache()
        phase_lm_train_reduced(dev, card)
        torch.cuda.empty_cache()
    if "lm_decode" in groups:
        # path 9: decode serving (counts zeroed inside)
        launches["lm_decode"], decode_ctx = phase_lm_decode(dev, card,
                                                            peaks(kind))
        torch.cuda.empty_cache()
    if "lm_scaleout" in groups:
        # path 10: the LM's sharded steps on a world of one, on lm_train's
        # and lm_decode's models (counts zeroed inside)
        launches["lm_scaleout"] = phase_lm_scaleout(dev, card, train_ctx,
                                                    decode_ctx)
    train_ctx = decode_ctx = None
    torch.cuda.empty_cache()
    if "lm_families" in groups:
        # path 11: the LM zoo (counts zeroed inside)
        launches["lm_families"] = phase_lm_families(dev, card, peaks(kind))

    last = {"ok": True, "device": {"platform": "gpu", "kind": kind,
                                   "count": torch.cuda.device_count()}}
    if groups != set(ONLY_GROUPS):
        emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
        print(smi, flush=True)
        emit(dict(last, only=sorted(groups, key=ONLY_GROUPS.index)))
        return
    for name, err in path_errs.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    kernels = []
    for name, spec in KERNELS.items():
        r = rows[name]
        by_path = {p: launches[p][name] for p in spec["paths"]}
        check(all(n > 0 for n in by_path.values()),
              f"{name} never launched on its path(s): {by_path}")
        kernels.append({
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"],
            "also_replaces": spec.get("also_replaces", []),
            "launches": sum(by_path.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "launches_by_path": by_path,
            # aliases: the TPU site, the kernel time, the bound in microseconds
            "tpu": spec["replaces"], "kernel_ms": r["ms"],
            "bound_us": r["bound"][0] * 1e3,
            "shape": r["shape"], "card": card})
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit(last)

if __name__ == "__main__":
    main()
