#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card, and hold every CUDA
kernel against its plain PyTorch version at the main path's shapes.

Run from the root of the repository, on a machine with one CUDA device:

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on a failure:

1. build: nvcc compiles the kernels of ``src/repro_torch/csrc`` for sm_90a
   (one compiler per source, all at once) and prints what ``-Xptxas -v``
   reports: registers, shared memory, spills; then the tensor-core
   instructions (HGMMA, HMMA) ``cuobjdump -sass`` finds in the flat scan's
   kernels (none fails the run).
2. kernels: each kernel against its plain version on the same CUDA tensors,
   at the main path's shapes (SIFT1M scale: n=1,000,000 rows of d=128, m=8
   filter columns, batches of 64). Prints the largest error, the id
   agreement outside near-ties, and the kernel's time beside its bound, the
   plain version's time and, where one PyTorch call computes the same
   function, that call's time (CUDA events, after a warm-up). The flat
   scan's bound is the larger of its bytes at the memory rate and its
   multiply-adds (2 b n d flops) at the tensor cores' peak (TF32 for fp32
   rows, bf16 otherwise), with the split's three products a multiply-add
   and the fp32 SIMT bound beside it as information; its yardstick is the
   library pair ``torch.addmm`` at "highest" fp32 precision plus
   ``torch.topk`` (``pair_ms``), timed only. B4's re-rank
   (``ops.rescore_topk``: the scores, their first-occurrence top-k and the
   ids, one launch) at kp = 80, 328 and 2056 is held bit for bit against
   the sequence it replaced (``ops.rescore``, ``topk_first``, a gather),
   and both are timed as a host loop (CUDA events around back-to-back
   calls) and as device time (``torch.profiler``'s kernel sum a call).
3. end to end, flat: a synthetic SIFT1M-shaped corpus, ``fcvi.build`` on
   the card with every ``FCVIConfig`` default, ``FCVIEngine`` with every
   ``EngineConfig`` default, then 512 queries, the first 64 again (cache
   hits), 1,000 inserts (the delta tier's scan goes through the rows
   kernel), 64 queries, ``compact()``, 64 queries, and one ``fcvi.query``
   call (the ids-only scan). The first batch is checked against a CPU
   engine (the plain path) on the same state; recall@10 is measured
   against ``ground_truth_combined`` on the card, held to >= 0.9 and to
   within 0.001 of its value before the tensor-core scan.
3b. end to end, IVF: the same corpus and queries with
   ``FCVIConfig(backend="ivf", nlist=1024, nprobe=16)`` (every other field
   and all of ``EngineConfig`` at their defaults). The build prints the
   k-means time and the list layout (max_list, mean list, pad fraction).
   Then the IVF kernels B5, B6 and B7 are held against their plain
   versions on the built index's slabs with a batch's coarse probes, at
   k=80 and k=320 (the escalated k'), as phase 2 holds the others. Then
   the same serving sequence as phase 3, one ``fcvi.query`` (B5) and one
   direct ``ops.ivf_score_topk_batch`` call on the index's slabs (B7: no
   serving path calls it, in the JAX package either). Checks: the first
   batch against a CPU engine on the same state; one batch at
   ``nprobe=nlist`` against the flat engine on the same corpus; recall@10
   printed beside the flat path's (IVF is approximate: no floor) and held
   to its value before the list scan's redesign (the same scores).
3c. end to end, PQ: the same corpus and queries with
   ``FCVIConfig(backend="pq")``, every field at its default (pq_m=8,
   pq_ksub=256, pq_coarse=32: 64-bit codes) and all of ``EngineConfig`` at
   its defaults. The build prints the coarse and subspace k-means seconds
   and the bytes of the codes and coarse ids. Then the PQ kernels B8, B9
   and B10 are held against their plain versions on the built index's
   codebooks, combined codes and one batch's LUTs (B9 at b=64 and at an
   escalation sub-batch's b=16, bit for bit, beside ``embedding_bag``, its
   bound and its LUT relayout's share of the device time; B10 beside its
   time before the redesign), and the first-occurrence top-k of the
   (64, 1M) ADC distances is timed and checked against a stable sort. The
   scan LUT (``ops.pq_scan_luts``: B8's cross term, the residual norms and
   the build's terms in one launch) is held bit for bit against its plain
   version at b=64, 16 and 1, timed as a host loop and as device time
   beside its bytes bound, the plain version and the chain of launches it
   replaced (step 0, PERF.md). Then the serving sequence of phase 3, one
   ``fcvi.query`` and one direct call each of ``ops.pq_lut_qdot``,
   ``ops.pq_score_batch`` and ``ops.pq_score`` (B8, B9 and B10: no serving
   path calls them). Checks: serving builds its LUTs through
   ``pq_scan_luts`` alone, the first batch against a CPU engine on the
   same state, queries at a candidate near-tie left out; recall@10 printed
   beside the flat and IVF values (PQ is approximate: no floor) and its
   last value before the scan LUT's kernel; on the same index, the first
   batch's ADC candidates over the kernel's table equal those over the
   chain it replaced outside the chain's near-ties (k'=80 and 320).
3d. the storage ladder, flat: the same corpus and queries with
   ``FCVIConfig(storage_dtype="bfloat16")`` and then ``"int8"`` (every other
   field and all of ``EngineConfig`` at their defaults). For each: the bytes
   of the stored rows, scales and norms on the card; the variant of B2 and
   B3 (``score_topk_bf16``/``_int8``, ``score_topk_rows_bf16``/``_int8``)
   against its plain version on the built index with the first batch's
   transformed queries, at kk=88 and 328 (scores within rtol 1e-5 / atol
   1e-4, ids equal outside near-ties, B3's (vals, ids) bit-equal to B2's,
   its carried rows bit-equal to the plain dequantized rows); the serving
   sequence of phase 3 (the delta tier stores its rows at the index's
   dtype) and one ``fcvi.query``; the first batch against a CPU engine on
   the same state; recall@10, held to >= 0.9 as in phase 3; and the share
   of the 512 queries whose top-10 equals the fp32 flat engine's.
3e. the storage ladder, IVF: ``FCVIConfig(backend="ivf", nlist=1024,
   nprobe=16, storage_dtype="int8")``. The build prints the bytes of the
   codes, scales and slabs. B5, B6 and B7 at int8 (with the grouped
   scales) are held against their plain versions as in phase 3b, and so
   are their bf16 variants on bf16 slabs built from the same lists. Then
   the serving sequence of phase 3, one ``fcvi.query`` and one direct
   ``ops.ivf_score_topk_batch`` call (B7 int8); the first batch against a
   CPU engine on the same state (probe near-ties left out); recall@10
   printed beside IVF fp32's and held to its value before the list scan's
   redesign. Last, an engine over the bf16
   slabs serves its warm-up batch and one batch of 64, one ``fcvi.query``
   and one direct B7 call, its first batch against a CPU engine too.
3f. predicate search (the filter algebra) on the same corpus with its raw
   attribute table (``attributes=corpus.filters``), over the indexes that
   phases 3, 3b, 3d and 3e built: P1 ``F.range("f7", 0.0, 0.6)``, P2
   ``F.eq("f0", 1.0) & F.range("f7", 0.25, 0.75)``, P3 ``F.eq("f5", 1.0)
   & F.range("f7", 0.0, 0.1)`` and P4 ``F.range("f7", 2.0, 3.0)`` (no
   row). First B2 masked (the flat fp32 and bf16 rows) and masked+scaled
   (the flat int8 codes) at kk=18 and 128 under the P2, P3 and a 10-row
   mask (dead slots exactly (-inf, 0)), and B5 ``mask=`` at k=18 on the
   IVF fp32, bf16 and int8 slabs, over every list under P2 and P3 and over
   the lists P3 routes to, against their plain versions (B5 ``mask=`` runs
   the flat tensor-core scan over the eligible slots; its selection path
   is timed beside it). The bound of a masked scan counts the eligible
   rows (the variants read those rows only) and the function's 2 b n_elig
   d flops at the tensor cores' peak, the larger. Then flat fp32, flat int8
   and IVF fp32 (nlist=1024, nprobe=16) engines serve a warm-up batch and
   512 queries in batches of 64 per predicate (qps, p50/p99, plan
   counters); each first batch against an fp64 brute force over the
   eligible rows on the card, then against a CPU engine on the same state;
   forced plans bit for bit (P1 fold = mask on flat, P3 routed = mask on
   IVF, with the lists P3 routes to); P4 certified empty; P2 after 1,000
   inserts against the oracle over both tiers; flat bf16, IVF bf16 and IVF
   int8 engines serve one batch of P2 and P3 each, checked against the
   oracle.
3g. shapes past the candidate buffers and wide rows: flat at
   ``EngineConfig(k=64)`` (512 timed queries), IVF at k'=3200, k=128/512
   steps through the selection path, a forced fold at kp=4096, a
   GIST1M-shaped flat corpus (n=1M, d=960) and an IVF corpus at d=384,
   each first batch against a CPU engine; B2, B3 and B2 masked at d=384
   and 960 and kk 88, 328 and 2056 against their plain versions (the L2
   tolerance plus a sqrt(d) depth term); the flat selection path bit-equal
   to the buffered one at kk 88, 328 and 1032, and against the plain
   version at kk 2048 and 2056; B5-B7 likewise at k 80 (bit-equal) and
   3200 (past the buffers: against the plain version); the
   select alone (``topk_select.select_topk``: the kernels every selection
   path runs) on phase 3's (64, 1M) scores at kk 88 and 2056, bit-equal to
   its plain version, beside ``torch.topk`` on the same scratch (its
   ``library_ms``) and its bytes bound, with its launches' spans; and on
   equal scores, where the four full-row histogram passes must run.
3h. the checkpoint lifecycle and the paper's query surfaces, on phase 3's
   flat fp32 index (n=1M, d=128) and phase 3d's flat bf16 index: each
   engine takes 1,000 inserts (pending), saves (``engine.save``, to a
   temporary directory removed afterwards) and restores on the card
   (``FCVIEngine.restore``); the restored first batch must equal the saved
   engine's bit for bit; the bytes written and the save and restore
   seconds are printed. The restored flat engine serves 512 queries of
   ``search_predicate`` under a price range (``f7`` in [0.3, 0.7], r =
   ``multi_probe_r`` = 4) in batches of 64 (qps, p50/p99). On the raw
   corpus, ``pre_filter_search`` (B2 masked), ``post_filter_search`` (B2),
   ``hybrid_search`` and FCVI multi-probe + verify (the multi-probe example's
   flow: k=200 candidates, the predicate, exact distance) give recall@10
   against ``ground_truth_filtered``; pre-filtering must equal it outside
   near-ties. Then B4 as multi-probe calls it (d = m = 8 at lam = 0, and
   the vectors at lam = 1) against its plain version in every slot, and the
   first multi-probe batch against a CPU engine restored from the same
   checkpoint.
3i. sharded, routed and degraded serving: the engine over 8 shards of
   ``make_mesh((8, 1), ("data", "model"))`` on this one card (the shards
   are logical: each holds its block in its own tensors and launches its
   own scans, back to back), on phase 3's flat fp32 index (contiguous
   dense, cluster routed), phase 3d's flat bf16 index (contiguous dense),
   phase 3b's IVF index (balanced dense and routed), phase 3c's PQ index
   (dense) and P3 over the IVF shards under the routed plan. Each case's
   512 timed queries (and a warm-up batch) must equal the meshless engine's
   on the same index bit for bit; both are timed (qps, batch p50/p99), with
   the shard build's seconds, the launches a batch by kernel, and the
   routed cases' shard_skip_rate and fallbacks, and the device memory
   each engine adds beside the index and its peak over the timed run
   (``torch.cuda.memory_allocated``). On the flat cluster routed
   and IVF balanced dense engines shard 3 is then marked dead: 128
   queries bit-equal to ``faultinject.surviving_reference`` on the card,
   the coverage certificate never under-flagged, ``coverage_rate``
   printed; then ``heal`` (checkpoint to a temporary directory, restore
   onto the 7 surviving shard positions, probe check, cutover), its
   seconds printed, and 128 more queries bit-equal to a meshless restore
   of that checkpoint at full coverage.
3j. the LM embedder's serving path: gemma3-1b at its published widths (26
   layers, d_model 1152, vocab 262144, about 1.0 B parameters) with weights
   drawn on the card from seed 0 (``repro_torch.models``). (a) 32,768 token
   documents of 128 tokens, whose leading block encodes one of 6 topics,
   are embedded in batches of 256 (the mean-pooled fp32 final hidden state;
   tokens/s and the weights' flops against the bf16 dense peak), the first
   documents held against the host's plain run of the same weights (cosine
   >= 0.9999); FCVI is built over the embeddings (d = 1152, m = 8, the
   serving example's ``FCVIConfig(alpha=2.0, lam=0.5, c=8.0)``) and served
   as ``examples/serve_filtered_search_torch.py`` serves it: 8 shards of
   ``make_host_mesh``, cluster placement, routed, 512 timed queries (the
   docs' own embeddings plus noise, their filters; qps, p50/p99, top-1
   topic match >= 0.9) bit-equal to a dense sharded engine and to the
   meshless one, 64 inserts, and a checkpoint round trip with identical
   results; B1, B3 and B4 must launch. (b) 8 prompts of 1024 tokens are
   prefilled (the local caches roll past the 512 window) and decoded 32
   steps; each step's logits lie within 0.15 (the reference test's drift
   bound) of the teacher-forced forward's at that position (computed only
   there). Prefill ms and decode ms a step are printed beside the step's
   bytes bound (the fp32 parameters read once).
3k. the other families at their published widths, weights drawn on the
   card from seed 0, one at a time: granite-moe-3b-a800m (MoE),
   recurrentgemma-2b (RG-LRU and local attention), xlstm-125m (mLSTM and
   sLSTM), whisper-large-v3 (the encoder-decoder over 1,500 audio-stub
   frames) and dbrx-132b (MoE, its depth cut to 2 of 40 layers: 526 GB of
   fp32 parameters do not fit). (a) The three decoder-only ones embed
   4,096 of 3j's documents (tokens/s; the share of the bf16 dense peak,
   MoE counted over all E x C dispatch slots), the first documents held
   against the host's plain run (cosine >= 0.9999, or, where the two lie
   further apart, the card no further from the same function computed
   without bf16 rounding than 1.5 times the host's angle from it; for
   granite the kept (token, expert) set against the host's is printed),
   and feed meshless FCVI (d = d_model, m = 8, the serving example's
   config; 512 timed queries, qps, p50/p99, top-1 topic match >= 0.9; B1,
   B3 and B4 must launch). (b) All five prefill 8 prompts (1024 tokens;
   whisper 384 after the frames) and decode 32 steps, MoE at capacity
   8.0, each step against the teacher-forced logits within 0.15, or 1.5
   times the reference's own drift where ``scripts/lm_drift.py`` measured
   it above that (xlstm, granite); for an MoE arch a (prompt, position)
   pair first routed otherwise than the forward where the forward's k-th
   and (k+1)-th router logits lie within the two computations' rounding
   is left out of the drift and counted (a flip elsewhere fails). The
   RG-LRU scan's launches and device time for one layer's prefill are
   printed beside a loop over positions'.
3l. training: gemma3-1b at its published widths (1,009,397,376
   parameters, remat on), weights drawn on the card from seed 0, trained
   through ``launch.train.main`` (``--full-config``): (a) 12 steps of 8 x
   1024 Markov tokens and a checkpoint at step 12; every loss and grad
   norm finite and the last 5 steps' mean loss below step 0's; ms a step,
   tokens/s, the bf16 peak share (6 N T, and 8 N T with the recompute),
   peak device memory beside its prediction, and the checkpoint's bytes
   and seconds. (c) The launcher's ``--resume`` restores it into a fresh
   model and state, bit-equal to the trained ones, and the next step's
   loss from them equals the uninterrupted run's (the n_micro=1 step of
   (b)) bit for bit. (b) One step at ``n_micro=2`` against one at
   ``n_micro=1`` from the trained state and the stream's next batch: max
   |d param| < 5e-3 (the reference's bound); one step's device time by
   kernel. (d) Reduced gradients of gemma3-1b, granite-moe-3b-a800m,
   recurrentgemma-2b, xlstm-125m and whisper-large-v3 on the card lie no
   further from the card's unrounded gradient than 1.5 times the host's
   distance from the host's. No kernel of ``SOURCES`` lies on this path; its launches are
   counted and printed (none).
3m. the model's shardings: gemma3-1b at its published widths, seed-0
   weights drawn on the card, on a logical (2, 2, 2) ("pod", "data",
   "model") mesh whose eight positions are all ``cuda:0``, under
   ``arch_rules`` (head_dim, ff and vocab on the model axis, the attention
   core sequence-parallel), ZeRO-1 moments and the int8 pod hop; 8 x 1024
   tokens of 3l's stream a step, remat on. (a) Step 0 from the seed-0
   state against the unsharded step and its twin computed without bf16
   rounding: loss and grad norm within 1.5 times the unsharded value's
   distance from the unrounded one (or 1e-3 of it); the synced gradient
   with the pod hop in fp32 by the CPU tests' rule (1.5 times, over all
   leaves and leaf by leaf); the int8 hop within 0.02 of each leaf's max
   from the fp32 hop; the new params within 2 lr of the unsharded step's.
   (b) 3 steps of the step function: finite losses, ms a step beside 3l's,
   the bytes a position holds of params, gradients and optimizer state
   beside the unsharded step's, the collective bytes a position a step by
   kind and axis, peak device memory (< 80 GB). (c) The heads-on-model
   layout: the reference test's reduced mistral-nemo-12b on a (4, 2)
   ("data", "model") mesh of the card under the default rules, one step
   held to the same step on the host (1.5 times the host's distance from
   its unrounded step). No kernel of ``SOURCES`` lies on this path.
3n. the dry-run (``repro_torch.launch.dryrun``) held to the card. (a) 3m's
   cell (gemma3-1b, 8 x 1024 tokens on the logical (2, 2, 2) mesh, fp32
   params, ZeRO-1, the int8 pod hop) traced on meta positions, every
   group and layer, and run once on the card under ``FlopCounterMode``:
   the trace's executed dot FLOPs equal the counter's, its collectives
   (bytes and counts by kind and axis) equal the real step's and 3m's
   step's, its whole-card live peak lies within [0.8, 1.25] of
   ``max_memory_allocated`` over the step (less what else the card
   holds), and 3m's measured step is at least 8 times the per-position
   bound. (b) The FCVI ``base`` and ``bf16`` cells at n = 2^24, d = 128,
   m = 8, 1,024 queries, k = 100, k' = 400 on a logical (2, 4) mesh, run
   for real (B2 on each of the 8 row blocks, the tree merge, the
   candidates' gather, the cosine re-rank): the k' candidates equal the
   exact L2 top-k' and the top-k the exact re-rank of those candidates,
   outside near-ties, B2's launches equal to the trace's
   ``score_topk`` calls, the measured time at least 8 times the
   per-position bound; B2's launches join the counts. (d) The IVF layouts'
   cells (``ivf8``, ``ivf8-trunc``, ``opt``) on the same mesh and corpus
   laid out as the reference's shard-major slab (8 blocks of 64 lists of
   32,768 bf16 rows), a warm run then a timed one each: B7 on each block
   (its launches equal to the trace's calls, 8 a run), the candidates
   equal to the search computed whole on the card (the same probes, every
   probed slot scored at once, the cuts, truncation and pads) outside
   near-ties, the top-k equal to the exact re-rank of the candidates,
   ``opt``'s top-k equal to ``ivf8-trunc``'s, the time at least 8 times
   the per-position bound; B7 alone at the cell's shape beside its bound,
   and ``ivf8``'s recall@k against the exhaustive search printed; B7's
   launches join the counts. (c) The table of
   every cell on both production meshes (``--all --mesh both``, meta
   positions only, so any host can write it), as a run of the dry-run
   wrote it to ``docs/dryrun_torch.json``: each cell's per-position peak against
   80 GB, its dominant roofline term and bound; every cell of the current
   lists must be there, ok or skipped, and gemma3-1b decode_32k on 16 x 16,
   traced again, must equal its row (a stale table fails).
4. a ``kernels`` JSON line with each kernel variant's launches over phases
   3 to 3n (each must be > 0), errors, times and bound, and the device
   time (``device_ms``) of B4, B8, B10 and the scan LUT, whose host loops
   sit near the
   host's cost of a launch (null for the others). No serving phase may
   re-rank past the fused re-rank's capacity (``rescore_wide``).

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device
the script prints no result and exits 1.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import clustering, fcvi, theory  # noqa: E402
from repro_torch.core.baselines import (BoxPredicate,  # noqa: E402
                                        build_hybrid, ground_truth_filtered,
                                        hybrid_search, post_filter_search,
                                        pre_filter_search)
from repro_torch.core.filters import F, compile_predicate  # noqa: E402
from repro_torch.core.filters import eval_mask  # noqa: E402
from repro_torch.data.synthetic import (CorpusSpec, make_corpus,  # noqa: E402
                                        sample_queries)
from repro_torch.index import flat as flat_mod  # noqa: E402
from repro_torch.index import ivf as ivf_mod  # noqa: E402
from repro_torch.index import pq as pq_mod  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import fused_score_topk as scan_mod  # noqa: E402
from repro_torch.kernels import ivf_score as ivf_kern  # noqa: E402
from repro_torch.kernels import pq_lut  # noqa: E402
from repro_torch.kernels import rescore as rescore_kern  # noqa: E402
from repro_torch.kernels import topk_select  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduced  # noqa: E402
from repro_torch.data.tokens import (TokenSpec,  # noqa: E402
                                     global_batch_iterator)
from repro_torch.launch import cost_analysis  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as launch_specs  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.launch.specs import (TRAIN_EXTRA_RULES,  # noqa: E402
                                      arch_rules)
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import recurrent as rec_mod  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.serve import faultinject  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train import optimizer as train_opt  # noqa: E402

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
# the card's peaks (NVIDIA H100 SXM5 data sheet): one home for them
PEAK_BYTES_S = cost_analysis.PEAK_BYTES_S
PEAK_FP32_S = cost_analysis.PEAK_FP32_S
PEAK_TF32_S = cost_analysis.PEAK_TF32_S     # dense TF32 on the tensor cores
PEAK_BF16_S = cost_analysis.PEAK_BF16_S     # dense bf16 on the tensor cores
PEAK_INT8_S = 1979e12     # dense int8 on the tensor cores, OP/s
FLAT_RECALL_BEFORE = 0.9992   # phase 3's flat recall@10 before the
                              # tensor-core scan (PERF.md)
# phases 3b's and 3e's IVF recall@10 before the list scan's redesign (fp32,
# int8; PERF.md): its scores are the same bits, so its results are too
IVF_RECALL_BEFORE = {"ivf": 0.9992, "ivf-int8": 0.9992}

N, D, M, B = 1_000_000, 128, 8, 64
KP = 80                      # k' of the defaults: k=10, lam=0.5, c=4
NLIST, NPROBE = 1024, 16     # IVF-Flat at SIFT1M's size: nlist ~ sqrt(n)
B_ESC = 16                   # an escalation sub-batch's size (B9 check)
# B9 by batch and B10 (host loop, device) before the query-innermost
# redesign (PERF.md, step 0), printed beside this run's times
B9_STEP0 = {B: 2.9828, B_ESC: 0.6472}
B10_STEP0 = (0.0696, 0.0471)
# scan_luts by batch (host loop, device) before pq_scan_luts: B8 and a
# chain of plain torch ops, nine launches (PERF.md, step 0)
LUTS_STEP0 = {B: (0.1826, 0.0762), B_ESC: (0.2611, 0.0304), 1: (0.2537,
                                                                0.0154)}
# pq_score_topk (b=64, n=1M, M=8) before its redesign for Hopper (PERF.md,
# the PR 16 kernel): ms by kk, the selection path at kk=2048
TOPK_STEP0 = {KP: 2.6878, 4 * KP: 4.4830, 2048: 1.0441}
# the shared memory's rate: 128 bytes a clock on each SM (Hopper)
SMEM_BYTES_CLK = 128
# phase 3c's recall@10 in the last run before pq_scan_luts, printed beside
# this run's: the PQ build's k-means sums with atomics on the card, so the
# codebooks, and the recall, move from run to run of the same code
PQ_RECALL_BEFORE = 0.6609
L2_RTOL, L2_ATOL = 1e-5, 1e-4
COS_ATOL = 1e-5

SOURCES = {
    "fused_transform": ("src/repro_torch/csrc/fcvi_transform.cu",
                        "src/repro/kernels/fcvi_transform.py:34"),
    "score_topk": ("src/repro_torch/csrc/fused_score_topk.cu",
                   "src/repro/kernels/fused_score_topk.py:191"),
    "score_topk_rows": ("src/repro_torch/csrc/fused_score_topk.cu",
                        "src/repro/kernels/fused_score_topk.py:287"),
    "rescore": ("src/repro_torch/csrc/rescore.cu",
                "src/repro/kernels/rescore.py:46"),
    "ivf_score_topk_dedup": ("src/repro_torch/csrc/ivf_score.cu",
                             "src/repro/kernels/ivf_score.py:209"),
    "ivf_score_topk_dedup_rows": ("src/repro_torch/csrc/ivf_score.cu",
                                  "src/repro/kernels/ivf_score.py:315"),
    "ivf_score_topk_batch": ("src/repro_torch/csrc/ivf_score.cu",
                             "src/repro/kernels/ivf_score.py:94"),
    "pq_lut_qdot": ("src/repro_torch/csrc/pq_lut.cu",
                    "src/repro/kernels/pq_lut.py:69"),
    # B8 fused with the rest of the scan LUT: the serving path's LUTs
    "pq_scan_luts": ("src/repro_torch/csrc/pq_lut.cu",
                     "src/repro/kernels/pq_lut.py:69"),
    "pq_score_batch": ("src/repro_torch/csrc/pq_lut.cu",
                       "src/repro/kernels/pq_lut.py:120"),
    "pq_score": ("src/repro_torch/csrc/pq_lut.cu",
                 "src/repro/kernels/pq_lut.py:36"),
    # the storage ladder's variants: the Pallas kernel body each replaces
    "score_topk_bf16": ("src/repro_torch/csrc/fused_score_topk.cu",
                        "src/repro/kernels/fused_score_topk.py:79"),
    "score_topk_int8": ("src/repro_torch/csrc/fused_score_topk.cu",
                        "src/repro/kernels/fused_score_topk.py:103"),
    "score_topk_rows_bf16": ("src/repro_torch/csrc/fused_score_topk.cu",
                             "src/repro/kernels/fused_score_topk.py:245"),
    "score_topk_rows_int8": ("src/repro_torch/csrc/fused_score_topk.cu",
                             "src/repro/kernels/fused_score_topk.py:245"),
    "ivf_score_topk_dedup_bf16": ("src/repro_torch/csrc/ivf_score.cu",
                                  "src/repro/kernels/ivf_score.py:146"),
    "ivf_score_topk_dedup_int8": ("src/repro_torch/csrc/ivf_score.cu",
                                  "src/repro/kernels/ivf_score.py:176"),
    "ivf_score_topk_dedup_rows_bf16": ("src/repro_torch/csrc/ivf_score.cu",
                                       "src/repro/kernels/ivf_score.py:270"),
    "ivf_score_topk_dedup_rows_int8": ("src/repro_torch/csrc/ivf_score.cu",
                                       "src/repro/kernels/ivf_score.py:270"),
    "ivf_score_topk_batch_bf16": ("src/repro_torch/csrc/ivf_score.cu",
                                  "src/repro/kernels/ivf_score.py:36"),
    "ivf_score_topk_batch_int8": ("src/repro_torch/csrc/ivf_score.cu",
                                  "src/repro/kernels/ivf_score.py:64"),
    # the filter algebra's variants: B2 masked (fp32, bf16) and
    # masked+scaled (int8), and B5's mask= (valid * mask, then the scan)
    "score_topk_masked": ("src/repro_torch/csrc/fused_score_topk.cu",
                          "src/repro/kernels/fused_score_topk.py:128"),
    "score_topk_masked_bf16": ("src/repro_torch/csrc/fused_score_topk.cu",
                               "src/repro/kernels/fused_score_topk.py:128"),
    "score_topk_masked_int8": ("src/repro_torch/csrc/fused_score_topk.cu",
                               "src/repro/kernels/fused_score_topk.py:154"),
    # B5 mask= runs the flat tensor-core scan over the eligible slots
    "ivf_score_topk_dedup_masked": ("src/repro_torch/csrc/fused_score_topk.cu",
                                    "src/repro/kernels/ivf_score.py:229"),
    "ivf_score_topk_dedup_masked_bf16": (
        "src/repro_torch/csrc/fused_score_topk.cu",
        "src/repro/kernels/ivf_score.py:229"),
    "ivf_score_topk_dedup_masked_int8": (
        "src/repro_torch/csrc/fused_score_topk.cu",
        "src/repro/kernels/ivf_score.py:229"),
    # the serving path's fused PQ scan + top-k (B9 and lax.top_k as one)
    "pq_score_topk": ("src/repro_torch/csrc/pq_lut.cu",
                      "src/repro/kernels/pq_lut.py:120"),
    # the selection path past the candidate buffers (or when forced)
    "pq_score_topk_select": ("src/repro_torch/csrc/pq_lut.cu",
                             "src/repro/kernels/pq_lut.py:120"),
    "score_topk_select": ("src/repro_torch/csrc/fused_score_topk.cu",
                          "src/repro/kernels/fused_score_topk.py:191"),
    "score_topk_rows_select": ("src/repro_torch/csrc/fused_score_topk.cu",
                               "src/repro/kernels/fused_score_topk.py:287"),
    "ivf_score_topk_dedup_select": ("src/repro_torch/csrc/ivf_score.cu",
                                    "src/repro/kernels/ivf_score.py:209"),
    "ivf_score_topk_dedup_rows_select": ("src/repro_torch/csrc/ivf_score.cu",
                                         "src/repro/kernels/ivf_score.py:315"),
    "ivf_score_topk_batch_select": ("src/repro_torch/csrc/ivf_score.cu",
                                    "src/repro/kernels/ivf_score.py:94"),
    # the selection path's select itself, counted wherever its kernels run
    # (every *_select launch above); it stands in for the TPU kernels'
    # running top-k
    "select": ("src/repro_torch/csrc/select_common.cuh",
               "src/repro/kernels/fused_score_topk.py:191"),
}
SUFFIX = {"float32": "", "bfloat16": "_bf16", "int8": "_int8"}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of ``fn`` on the card over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_FP32_S):
    """(least time in ms, what bounds it) from bytes moved and operations
    at ``peak``, the rate of their type (fp32 outside the tensor cores by
    default)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def op_peak(dtype) -> float:
    """The card's peak operation rate for operands of ``dtype``: the
    tensor cores' for bf16 and int8, fp32's outside them otherwise."""
    return {torch.bfloat16: PEAK_BF16_S,
            torch.int8: PEAK_INT8_S}.get(dtype, PEAK_FP32_S)


def scan_bound_ms(nbytes: float, pairs: float, d: int, dtype):
    """(least time in ms, what bounds it, the unit) of the flat scan B2/B3:
    its bytes at the memory rate, or the function's own operations (a
    multiply-add a (query, row, column), two flops) at the published peak
    of the tensor-core unit it runs on (TF32 for fp32 rows, bf16 for bf16
    and int8 rows), the larger. The split's three products per multiply-add
    are the kernel's cost, not the function's: the unit's description
    gives their time beside it, as information."""
    tf32 = dtype == torch.float32
    peak = PEAK_TF32_S if tf32 else PEAK_BF16_S
    t_ops = 2 * pairs * d / peak
    t_bytes = nbytes / PEAK_BYTES_S
    unit = (f"{'TF32' if tf32 else 'bf16'} tensor cores; the split's three "
            f"products {1e3 * 3 * t_ops:.4f} ms")
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", unit)


def pair_ms(x, sq, q, kk, scales=None, mask=None, iters=3) -> float:
    """The library pair that computes the flat scan's function: torch.addmm
    at "highest" fp32 precision (2 q x - ||x||^2, on the dequantized rows)
    then torch.topk, timed as a yardstick; the port never calls it."""
    rows = x.float() if scales is None else x.float() * scales[:, None]
    q2 = torch.sum(q * q, dim=-1, keepdim=True)
    neg = -sq[None, :]
    keep = None if mask is None else mask[None, :] > 0.5
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")

    def pair():
        s = torch.addmm(neg, q, rows.T, alpha=2.0) - q2
        if keep is not None:
            s = torch.where(keep, s, float("-inf"))
        return torch.topk(s, kk)
    try:
        return time_ms(pair, iters)
    finally:
        torch.set_float32_matmul_precision(prec)
        del rows


def ids_outside_ties(ref_vals, ref_ids, ids, rtol, atol):
    """(agreeing, compared) id slots outside the reference's near-ties: a
    slot is a near-tie when its reference score lies within atol + rtol *
    |score| of a neighbour. ``ref_vals`` carries one score more than the
    slots compared, so the last slot's successor is known."""
    rv = ref_vals.double().cpu().numpy()
    k = ids.shape[1]
    gap = np.abs(np.diff(rv, axis=1))
    tol = atol + rtol * np.abs(rv)
    tie = np.zeros(rv.shape, bool)
    tie[:, 1:] |= gap <= tol[:, 1:]
    tie[:, :-1] |= gap <= tol[:, :-1]
    keep = ~tie[:, :k]
    same = (ids.cpu().numpy() == ref_ids[:, :k].cpu().numpy())
    return int((same & keep).sum()), int(keep.sum())


def tol_share(got, want, atol=L2_ATOL) -> float:
    """The largest |got - want| as a share of the L2 tolerance, atol + rtol
    |want| (atol a number or a (b, 1) tensor), over the slots where want is
    finite."""
    live = torch.isfinite(want)
    share = (got - want).abs() / (atol + L2_RTOL * want.abs())
    return share[live].max().item() if bool(live.any()) else 0.0


def fp64_errs(x, sq, q, vals, ids, scales=None):
    """(the scan's, the plain fp32 version's) largest distance from the
    fp64 scores of the same rows, over the live (finite) slots: the
    function's exact value on the same stored rows, scales and norms. The
    plain scores are ``ref.ref_score_topk``'s, in its order."""
    live = torch.isfinite(vals)
    if not bool(live.any()):
        return 0.0, 0.0
    idx = ids.long()
    s = 2.0 * ref.dot_rounded(q, x)
    if scales is not None:
        s = s * scales
    s = (s - sq[None, :]) - torch.sum(q * q, dim=-1, keepdim=True)
    plain = torch.gather(s, 1, idx)
    del s
    xd = x[idx].double()
    if scales is not None:
        xd = xd * scales.double()[idx][..., None]
    qd = q.double()[:, None, :]
    exact = 2.0 * (xd * qd).sum(-1) - sq.double()[idx] - (qd * qd).sum(-1)
    return tuple((t.double() - exact)[live].abs().max().item()
                 for t in (vals, plain))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"[build] nvcc, sm_90a, {time.perf_counter() - t0:.1f} s")
    print(_build.build_log().rstrip())
    # the flat scan's dot products come off the tensor cores: count the
    # warpgroup (HGMMA) and warp (HMMA) MMA instructions of its kernels
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            func = line.split("Function :")[1].strip()
        elif func and "scan_kernel" in func and "fused_score" in func:
            for op in ("HGMMA", "HMMA"):
                if op in line:
                    counts[op] = counts.get(op, 0) + 1
    print(f"[build] flat scan kernels (fused_score_topk.cu scan_kernel, every "
          f"instantiation): {counts.get('HGMMA', 0)} HGMMA and "
          f"{counts.get('HMMA', 0)} HMMA instructions in the SASS")
    check(counts.get("HGMMA", 0) + counts.get("HMMA", 0) > 0,
          "the flat scan has no tensor-core instruction")


def phase_kernels(dev, gen, power: str) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    res = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # B1 fused_transform: the engine's query transform (64 rows) and the
    # corpus transform of build/compaction (1M rows); identity normalizers,
    # 0/1 partition fold, as the hot path calls it
    p = ref.partition_matrix(D, M, device=dev)
    alpha = 1.0
    for rows in (B, N):
        vn, fn = randn(rows, D), randn(rows, M)
        got = ops.fused_transform(vn, fn, p, alpha)
        want = ref.ref_fused_transform(vn, fn, p, alpha)
        err = (got - want).abs().max().item()
        check(err <= 1e-5, f"fused_transform ({rows}, {D}) error {err}")
        ms = time_ms(lambda: ops.fused_transform(vn, fn, p, alpha), 20)
        plain = time_ms(lambda: ref.ref_fused_transform(vn, fn, p, alpha), 20)
        lib = time_ms(lambda: torch.addmm(vn, fn, p, alpha=-alpha), 20)
        bnd, by = bound_ms(4 * (2 * rows * D + rows * M + M * D),
                           rows * D * (2 * M + 2))
        print(f"[kernel] fused_transform ({rows},{D})x({rows},{M}): max_abs_err "
              f"{err:.3g} kernel_ms {ms:.4f} plain_ms {plain:.4f} "
              f"library_ms(addmm) {lib:.4f} bound_ms {bnd:.4f} ({by}); card "
              f"{power}")
        res["fused_transform"] = dict(
            max_abs_err=max(err, res.get("fused_transform", {}).get(
                "max_abs_err", 0.0)),
            ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib)
        del vn, fn, got, want

    # B2 score_topk / B3 score_topk_rows at b=64 against the 1M-row corpus,
    # kk = k'+REFINE_PAD with the defaults (88) and escalated (328)
    x = randn(N, D)
    sq = torch.sum(x * x, dim=-1)
    q = randn(B, D)
    pv, pf = randn(N, D), randn(N, M)
    scan_in = 4 * (N * D + N + B * D)
    simt_ops = 2 * B * N * D + 3 * B * N
    for kk in (88, 328):
        vals, ids = ops.score_topk(x, sq, q, kk)
        rvals, rids = ref.ref_score_topk(x, sq, q, kk + 1)
        err = (vals - rvals[:, :kk]).abs().max().item()
        agree, total = ids_outside_ties(rvals, rids, ids, L2_RTOL, L2_ATOL)
        share = tol_share(vals, rvals[:, :kk])
        e64, p64 = fp64_errs(x, sq, q, vals, ids)
        check(share <= 1.0, f"score_topk kk={kk} error {err}: {share:.3f} "
              "of its slot's tolerance")
        check(agree == total, f"score_topk kk={kk}: {total - agree} ids "
              "differ outside near-ties")
        out = ops.score_topk_rows(x, sq, pv, pf, q, kk)
        idx = ids.long()
        check(torch.equal(out[0], vals) and torch.equal(out[1], ids),
              "score_topk_rows (vals, ids) differ from score_topk")
        check(torch.equal(out[2], x[idx]) and torch.equal(out[3], pv[idx])
              and torch.equal(out[4], pf[idx]),
              "score_topk_rows rows differ from the gathered rows")
        ms = time_ms(lambda: ops.score_topk(x, sq, q, kk))
        ms_rows = time_ms(lambda: ops.score_topk_rows(x, sq, pv, pf, q, kk))
        plain = time_ms(lambda: ref.ref_score_topk(x, sq, q, kk), 5)
        plain_rows = time_ms(
            lambda: ref.ref_score_topk_rows(x, sq, pv, pf, q, kk), 5)
        pair = pair_ms(x, sq, q, kk)
        bnd, by, unit = scan_bound_ms(scan_in + 8 * B * kk, B * N, D,
                                      x.dtype)
        rows_bytes = 4 * B * kk * (2 * (D + M) + D)
        bnd_rows, by_rows, _ = scan_bound_ms(
            scan_in + 8 * B * kk + rows_bytes, B * N, D, x.dtype)
        simt, _ = bound_ms(scan_in + 8 * B * kk, simt_ops)
        print(f"[kernel] score_topk b={B} n={N} d={D} kk={kk}: max_abs_err "
              f"{err:.3g} ({share:.3f} of the tolerance; against fp64 the "
              f"scan {e64:.3g}, the plain version {p64:.3g}) ids "
              f"{agree}/{total} outside near-ties; kernel_ms "
              f"{ms:.4f} plain_ms {plain:.4f} pair_ms {pair:.4f} bound_ms "
              f"{bnd:.4f} ({by}, {unit}; fp32 SIMT bound "
              f"{simt:.4f}); card {power}")
        print(f"[kernel] score_topk_rows kk={kk}: rows exact; kernel_ms "
              f"{ms_rows:.4f} plain_ms {plain_rows:.4f} pair_ms {pair:.4f} "
              f"bound_ms {bnd_rows:.4f} ({by_rows}); card {power}")
        if kk == 88:  # the main path's default width goes in the JSON line
            res["score_topk"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                     bound_by=by, library_ms=None)
            res["score_topk_rows"] = dict(ms=ms_rows, plain_ms=plain_rows,
                                          bound_ms=bnd_rows,
                                          bound_by=by_rows, library_ms=None)
        for name in ("score_topk", "score_topk_rows"):
            res[name]["max_abs_err"] = max(err, res[name].get("max_abs_err",
                                                              0.0))
        del vals, ids, rvals, rids, out
    del x, sq, q, pv, pf

    # B4 on the engine's candidate tiles: the scores alone (ops.rescore),
    # and the re-rank the main path runs (ops.rescore_topk: the scores,
    # their first-occurrence top-k and the ids, one launch) beside the
    # sequence it replaced (ops.rescore, topk_first, gather), at the
    # default k', the flat path's escalated k' and EngineConfig(k=64)'s
    for kp, k in ((KP, 10), (328, 10), (2056, 64)):
        cv, cf = randn(B, kp, D), randn(B, kp, M)
        qn, fqn = randn(B, D), randn(B, M)
        cand = torch.randint(0, N, (B, kp), generator=gen, device=dev,
                             dtype=torch.int32)
        got = ops.rescore(cv, cf, qn, fqn, 0.5)
        err = (got - ref.ref_rescore(cv, cf, qn, fqn, 0.5)).abs().max().item()
        check(err <= COS_ATOL, f"rescore kp={kp} error {err}")

        def seq():
            vals, pos = ref.topk_first(ops.rescore(cv, cf, qn, fqn, 0.5), k)
            return vals, torch.gather(cand, -1, pos)

        def fused():
            return ops.rescore_topk(cv, cf, qn, fqn, 0.5, cand, k)

        gv, gi = fused()
        sv, si = seq()
        check(torch.equal(gv.view(torch.int32), sv.view(torch.int32))
              and torch.equal(gi, si), f"rescore_topk kp={kp} differs from "
              "ops.rescore + topk_first + gather")
        pv, pi = ref.ref_rescore_topk(cv, cf, qn, fqn, 0.5, cand, k + 1)
        err = max(err, (gv - pv[:, :k]).abs().max().item())
        agree, total = ids_outside_ties(pv, pi, gi, 0.0, COS_ATOL)
        check(err <= COS_ATOL and agree == total, f"rescore_topk kp={kp}: "
              f"error {err}, {total - agree} ids differ outside near-ties")
        ms, (dev_ms, _, n_fused) = time_ms(fused, 50), device_time(fused)
        ms_seq, (dev_seq, _, n_seq) = time_ms(seq, 50), device_time(seq)
        one = (lambda: ops.rescore(cv, cf, qn, fqn, 0.5))
        ms_one, dev_one = time_ms(one, 50), device_time(one)[0]
        plain = time_ms(lambda: ref.ref_rescore_topk(cv, cf, qn, fqn, 0.5,
                                                     cand, k), 50)
        bnd, by = bound_ms(4 * (B * kp * (D + M + 1) + B * (D + M))
                           + 8 * B * k, B * kp * (6 * (D + M) + 12))
        print(f"[kernel] rescore_topk ({B},{kp},{D})/({B},{kp},{M}) k={k}: "
              f"max_abs_err {err:.3g}, ids {agree}/{total} outside near-ties, "
              f"bit-equal to the sequence; host loop {ms:.4f} ms, device "
              f"{dev_ms:.4f} ms ({n_fused:g} launch); the sequence it "
              f"replaced (rescore, topk_first, gather): host loop "
              f"{ms_seq:.4f}, device {dev_seq:.4f} ({n_seq:g} launches); "
              f"rescore alone: host loop {ms_one:.4f}, device {dev_one:.4f}; "
              f"plain_ms {plain:.4f} bound_ms {bnd:.5f} ({by}); card {power}")
        if kp == KP:
            res["rescore"] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                                  plain_ms=plain, bound_ms=bnd, bound_by=by,
                                  library_ms=None)
        del cv, cf, qn, fqn, cand
    torch.cuda.empty_cache()
    return res


@dataclasses.dataclass
class Inputs:
    """The corpus and query stream both end-to-end phases serve (host)."""

    corpus: object
    q_all: np.ndarray      # 640 queries: 512 timed, then 64 + 64 after inserts
    f_all: np.ndarray
    q_warm: np.ndarray     # the warm-up batch, apart from the timed ones
    f_warm: np.ndarray
    new_v: np.ndarray      # 1,000 inserts
    new_f: np.ndarray


def make_inputs() -> Inputs:
    t0 = time.perf_counter()
    corpus = make_corpus(CorpusSpec(n=N, d=D, n_categories=6, n_numeric=2,
                                    seed=0))
    q_all, f_all = sample_queries(corpus, 512 + 64 + 64, seed=1)
    q_warm, f_warm = sample_queries(corpus, B, seed=3)
    rng = np.random.default_rng(2)
    new_v = (corpus.vectors[rng.integers(0, N, 1000)]
             + 0.1 * rng.normal(size=(1000, D))).astype(np.float32)
    new_f = corpus.filters[rng.integers(0, N, 1000)]
    print(f"[e2e] corpus n={N} d={D} m={M}: {time.perf_counter() - t0:.1f} s "
          "(host, setup)")
    return Inputs(corpus, q_all, f_all, q_warm, f_warm, new_v, new_f)


def serve(tag: str, eng, inp: Inputs, power: str):
    """The serving sequence of phases 3 and 3b: a warm-up batch, 512 timed
    queries in batches of 64, the first 64 again (cache hits), 1,000
    inserts, 64 queries, ``compact()``, 64 queries. Returns (scores, ids)
    of the 512."""
    t0 = time.perf_counter()
    eng.search(inp.q_warm, inp.f_warm)   # first-call allocations, kept apart
    cold = time.perf_counter() - t0
    warm_esc = eng.stats.escalations
    lat, served = [], []
    for s in range(0, 512, B):
        t0 = time.perf_counter()
        served.append(eng.search(inp.q_all[s:s + B], inp.f_all[s:s + B]))
        lat.append(time.perf_counter() - t0)
    scores = np.concatenate([s for s, _ in served])
    ids = np.concatenate([i for _, i in served])
    check(scores.shape == (512, 10) and np.isfinite(scores).all(),
          f"{tag}: scores are not finite (512, 10)")
    check(((ids >= 0) & (ids < N)).all(), f"{tag}: ids out of range")
    esc = eng.stats.escalations - warm_esc
    again = eng.search(inp.q_all[:B], inp.f_all[:B])
    check(eng.stats.cache_hits == B, f"{tag}: the repeated batch missed the "
          "cache")
    check(np.array_equal(again[1], ids[:B]), f"{tag}: cached ids differ")
    eng.insert(inp.new_v, inp.new_f)
    mid = eng.search(inp.q_all[512:576], inp.f_all[512:576])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    check(eng.index.size == N + 1000 and eng.stats.compactions == 1,
          f"{tag}: compaction did not fold the inserts")
    late = eng.search(inp.q_all[576:], inp.f_all[576:])
    for s, i in (mid, late):
        check(np.isfinite(s).all() and ((i >= 0) & (i < N + 1000)).all(),
              f"{tag}: post-insert results out of range")
    total_s = sum(lat)
    print(f"[{tag}] 512 queries in batches of {B}: qps {512 / total_s:.1f} "
          f"batch p50 {1e3 * np.percentile(lat, 50):.2f} ms p99 "
          f"{1e3 * np.percentile(lat, 99):.2f} ms (first, cold batch "
          f"{1e3 * cold:.2f} ms, not in these); escalations {esc} of 512; "
          f"cache hits {eng.stats.cache_hits}; compact() {compact_s:.2f} s; "
          f"card {power}")
    print(f"[{tag}] batch ms {[round(1e3 * t, 2) for t in lat]}")
    return scores, ids


def recall_vs_truth(index, state0, inp: Inputs, ids, dev) -> float:
    """recall@10 of ``ids`` (the 512 timed queries) against the exact
    combined-score top-10 over the original corpus, on the card."""
    vn, fn = state0["vectors_n"], state0["filters_n"]
    true = []
    for s in range(0, 512, B):
        qn, fqn = index.transform.normalize(
            torch.tensor(inp.q_all[s:s + B], device=dev),
            torch.tensor(inp.f_all[s:s + B], device=dev))
        true.append(fcvi.ground_truth_combined(vn, fn, qn, fqn, 10, 0.5)[1]
                    .cpu().numpy())
    return fcvi.recall_at_k(ids, np.concatenate(true))


def margins(eng, q: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Each query's first-stage top-k margin, as the engine's escalation
    test reads it."""
    k = eng.cfg.k
    kp = theory.k_prime(k, 0.5, 1.0, eng.index.size, 4.0)
    dev = eng.device
    _, _, margin = eng._step(None, torch.tensor(q, device=dev),
                             torch.tensor(f, device=dev), k=k, kp=kp, kd=0)
    return margin.cpu().numpy()


def same_top10(tag: str, scores, ids, want_s, want_i, exclude) -> None:
    """Combined scores within COS_ATOL and ids equal outside near-ties of
    the reference (want_*), over the queries not in ``exclude``; any k,
    10 on the default path."""
    rows = ~exclude
    err = float(np.abs(scores[rows] - want_s[rows]).max())
    check(err <= COS_ATOL, f"{tag}: scores differ by {err}")
    diff = np.zeros_like(want_s, bool)
    diff[rows] = ids[rows] != want_i[rows]
    gap = np.abs(np.diff(want_s.astype(np.float64), axis=1))
    tie = np.zeros_like(diff)
    tie[:, 1:] |= gap <= COS_ATOL
    tie[:, :-1] |= gap <= COS_ATOL
    tie[:, -1] = True          # the reference's (k+1)-th score is unknown
    check(not (diff & ~tie).any(), f"{tag}: ids differ outside near-ties")
    print(f"[{tag}] max score err {err:.3g}, {int(diff.sum())} id slots "
          f"differ, all at near-ties; {int(exclude.sum())} of "
          f"{len(exclude)} queries excluded")


def against_cpu_engine(tag: str, index, state0, scores, ids, q, f,
                       exclude, cfg=None, cpu_ix=None) -> np.ndarray:
    """The first batch against a CPU engine (the plain path) on the same
    state, under ``cfg`` (the defaults when None); escalation-boundary
    queries and those in ``exclude`` are left out. ``cpu_ix``: the state
    already on the host. Returns the CPU engine's ids."""
    t0 = time.perf_counter()
    if cpu_ix is None:
        cpu_ix = fcvi.index_from_state(index.config, state0, device="cpu")
    cfg = cfg or engine_mod.EngineConfig()
    cpu_eng = engine_mod.FCVIEngine(cpu_ix, cfg, device="cpu")
    cs, ci = cpu_eng.search(q, f)
    edge = np.abs(margins(cpu_eng, q, f) - cpu_eng.cfg.escalate_margin) < 1e-5
    same_top10(f"{tag} first batch vs CPU engine (plain path)", scores, ids,
               cs, ci, edge | exclude)
    print(f"[{tag}] {int(edge.sum())} escalation-boundary queries excluded; "
          f"{time.perf_counter() - t0:.1f} s")
    return ci


def phase_end_to_end(dev, power: str, inp: Inputs):
    """The flat path at SIFT1M scale; returns its kernels' launch counts,
    recall@10, the 512 timed queries' ids and the index as built (phase
    3f serves it again)."""
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    index = fcvi.build(inp.corpus.vectors, inp.corpus.filters,
                       fcvi.FCVIConfig(), device=dev)
    torch.cuda.synchronize()
    print(f"[e2e] build on the card: {time.perf_counter() - t0:.2f} s")
    state0 = fcvi.index_state(index)
    eng = engine_mod.FCVIEngine(index, engine_mod.EngineConfig(), device=dev)
    scores, ids = serve("e2e", eng, inp, power)
    qv, qf = (torch.tensor(a, device=dev) for a in (inp.q_all[:B],
                                                    inp.f_all[:B]))
    fcvi.query(eng.index, qv, qf, 10)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"[e2e] counts {json.dumps(counts)}")
    recall = recall_vs_truth(index, state0, inp, ids, dev)
    print(f"[e2e] recall@10 {recall:.4f} over 512 queries (before the "
          f"tensor-core scan: {FLAT_RECALL_BEFORE}); card {power}")
    check(recall >= 0.9, f"recall@10 {recall} below 0.9")
    check(abs(recall - FLAT_RECALL_BEFORE) <= 0.001, f"recall@10 {recall} "
          f"moved from {FLAT_RECALL_BEFORE}")
    against_cpu_engine("e2e", index, state0, scores[:B], ids[:B],
                       inp.q_all[:B], inp.f_all[:B], np.zeros(B, bool))
    return counts, recall, ids, index


def probe_ties(centroids, q_t, nprobe) -> np.ndarray:
    """(b,) bool: queries whose nprobe-th and (nprobe+1)-th coarse scores
    (float64) lie within the L2 tolerance: fp32 rounding may give the card
    and the CPU different probe sets there."""
    c = centroids.double().cpu().numpy()
    q = q_t.double().cpu().numpy()
    d2 = np.sort(((q * q).sum(1)[:, None] - 2 * q @ c.T
                  + (c * c).sum(1)[None]), axis=1)
    a, b = d2[:, nprobe - 1], d2[:, nprobe]
    return (b - a) <= L2_ATOL + L2_RTOL * np.abs(b)


def ivf_bound(be, uniq, member, nq, k, row_floats):
    """(bound ms, what bounds it, real-row bytes, padded bytes) of one IVF
    scan: the unique probed lists' valid flags and live rows (stored vector,
    norm and, for int8, scale) read once, the queries and member matrix
    read, (vals, ids) and ``row_floats`` payload floats per winner written
    (and read); operations 2d + 2 per (member pair, live row), one more
    with a scale, at the peak of the stored rows' type (``op_peak``)."""
    sizes = be.list_sizes.long().cpu().numpy()
    mem = member.cpu().numpy() > 0.5
    live = mem.any(axis=1)
    lists = uniq.long().cpu().numpy()[live]
    rows = int(sizes[lists].sum())
    pair_rows = int((mem[live].sum(axis=1) * sizes[lists]).sum())
    d = be.grouped.shape[-1]
    row_bytes = d * be.grouped.element_size() + 4
    per_op = 2 * d + 2
    if be.grouped_scales is not None:
        row_bytes += 4
        per_op += 1
    real = rows * row_bytes + 4 * len(lists) * be.max_list
    padded = len(lists) * be.max_list * (row_bytes + 4)
    io = 4 * (nq * d + member.numel()) + 8 * nq * k + 8 * nq * k * row_floats
    bnd, by = bound_ms(real + io, pair_rows * per_op,
                       op_peak(be.grouped.dtype))
    return bnd, by, real, padded


def member_stats(be, uniq, member) -> dict:
    """A batch's probed lists: how many, how many member queries each (a
    histogram), their live rows, the member pairs (query, live row), and
    the passes the list scan makes over them (``ivf_score.list_passes``
    at its plan's default of Q_MAX member queries a pass)."""
    mem = member.cpu().numpy() > 0.5
    per = mem.sum(axis=1)
    live = per > 0
    sizes = be.list_sizes.long().cpu().numpy()[uniq.long().cpu().numpy()]
    hist = np.bincount(per[live])
    passes = ivf_kern.list_passes(member).cpu().numpy()
    out = dict(unique_lists=int(live.sum()), probes=int(per.sum()),
               members_mean=float(per[live].mean()),
               members_max=int(per.max()),
               members_hist={int(m): int(c) for m, c in enumerate(hist) if c},
               live_rows=int(sizes[live].sum()),
               pair_rows=int((per * sizes).sum()),
               list_rows_median=float(np.median(sizes[live])),
               list_rows_max=int(sizes[live].max()),
               passes=int(passes.sum()),
               rows_read_by_passes=int((passes * sizes).sum()))
    print(f"[members] {out['unique_lists']} unique lists for "
          f"{out['probes']} probes: {out['members_mean']:.3f} member "
          f"queries a list (max {out['members_max']}); lists by members "
          f"{out['members_hist']}; live rows {out['live_rows']} (a list: "
          f"median {out['list_rows_median']:.0f}, max "
          f"{out['list_rows_max']}); member pairs x rows {out['pair_rows']}; "
          f"the list scan: {out['passes']} list passes reading "
          f"{out['rows_read_by_passes']} rows")
    return out


def device_time(fn, calls: int = 10):
    """(device ms a call summed over its kernels, {kernel: device ms a
    call}, kernel launches a call) of ``fn``, from torch.profiler over
    ``calls`` calls after one: each kernel's mean time times its launches a
    call, rounded to a whole number. The trace may drop a launch's record
    (a sum over the calls would count it as no time), or every record: then
    it is taken again, up to three times."""
    fn()
    torch.cuda.synchronize()
    split, launches = {}, 0
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
                name = e.key.replace("(anonymous namespace)::", "")
                name = name.split("(")[0][:48]
                per_call = max(1, round(e.count / calls))
                split[name] = split.get(name, 0.0) + (
                    e.self_device_time_total / 1e3 / e.count * per_call)
                launches += per_call
        if split:
            break
    return sum(split.values()), split, launches


def kernel_split(fn, calls: int = 10) -> dict:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler
    over ``calls`` calls, after one)."""
    return device_time(fn, calls)[1]


def depth_atol(q_t, rows, d: int) -> torch.Tensor:
    """(b, 1) the absolute term a d-term fp32 dot product's rounding adds to
    a score: sqrt(d) u ||q|| max ||x|| (u = 2^-24), the usual estimate of a
    d-term sum's rounding, sqrt(d) u sum |q_i x_i| (the worst case has d in
    place of sqrt(d)), doubled for the score's 2 <q, x> and again for two
    implementations that sum in different orders (the kernel, and a plain
    version that splits or reorders the sum). Phase 3g adds it to the L2
    tolerance at the widths it brings (d=384, 960)."""
    xmax = torch.sqrt(torch.max(torch.sum(rows.float() ** 2, dim=-1)))
    qn = torch.sqrt(torch.sum(q_t * q_t, dim=-1, keepdim=True))
    return 4.0 * d ** 0.5 * 2.0 ** -24 * qn * xmax


def ivf_kernels(index, qb: np.ndarray, fb: np.ndarray, dev, power: str,
                ks=(KP, 4 * KP), depth: bool = False) -> dict:
    """B5, B6 and B7 against their plain versions on the built index's slabs
    (the variants of its storage dtype, with its grouped scales), with the
    coarse probes of the batch (qb, fb), at k in ``ks`` (80 and 320: the
    default k' and its escalation). The results of ks[0] are returned.
    ``depth``: add ``depth_atol`` to the L2 tolerance (phase 3g)."""
    be = index.backend
    sc = be.grouped_scales
    suffix = SUFFIX[index.config.storage_dtype]
    q = torch.tensor(qb, device=dev)
    f = torch.tensor(fb, device=dev)
    q_t = index.transform.apply(q, f).contiguous()
    c2 = torch.sum(be.centroids * be.centroids, dim=-1)
    _, probes = ops.score_topk(be.centroids, c2, q_t, NPROBE)
    uniq, member = ops.dedup_probes(probes, NLIST)
    gpv = ivf_mod.build_grouped_payload(index.vectors_n, be.lists)
    gpf = ivf_mod.build_grouped_payload(index.filters_n, be.lists)
    n_live = int((member > 0.5).any(dim=1).sum())
    print(f"[ivf-kernel] batch of {B}: {n_live} unique probed lists of "
          f"{NLIST} ({B * NPROBE} probes); slabs {be.grouped.dtype}")
    member_stats(be, uniq, member)
    grp = (be.grouped, be.grouped_sq, be.valid)
    ded = (*grp, uniq, member, q_t)
    d = be.grouped.shape[-1]
    res = {}
    for k in ks:
        vals, ids = ops.ivf_score_topk_dedup(*ded, k, scales=sc)
        rvals, rids = ref.ref_ivf_score_topk_dedup(*ded, k + 1, sc)
        out = ops.ivf_score_topk_dedup_rows(*ded, gpv, gpf, k, scales=sc)
        check(torch.equal(out[0], vals) and torch.equal(out[1], ids),
              "ivf_score_topk_dedup_rows (vals, ids) differ from B5's")
        dead = torch.isneginf(vals)[..., None]
        idx = ids.long()
        check(torch.equal(out[2], torch.where(dead, 0.0,
                                              gpv.reshape(-1, d)[idx]))
              and torch.equal(out[3], torch.where(dead, 0.0,
                                                  gpf.reshape(-1, M)[idx])),
              "ivf_score_topk_dedup_rows rows differ from the gathered rows")
        bv, bi = ops.ivf_score_topk_batch(*grp, probes, q_t, k, scales=sc)
        rbv, rbi = ref.ref_ivf_score_topk_batch(*grp, probes, q_t, k + 1, sc)
        if not ivf_kern.plan(k, d, be.grouped.dtype).select:
            # the selection path forced: the buffered path's bits
            sel = (ivf_kern.ivf_score_topk_dedup(*ded, k, sc, _select=True),
                   ivf_kern.ivf_score_topk_dedup_rows(*ded, gpv, gpf, k, sc,
                                                      _select=True),
                   ivf_kern.ivf_score_topk_batch(*grp, probes, q_t, k, sc,
                                                 _select=True))
            check(all(all(torch.equal(u, v) for u, v in zip(a, b_))
                      for a, b_ in zip(sel, ((vals, ids), out, (bv, bi)))),
                  f"B5-B7 {be.grouped.dtype} k={k}: the selection path "
                  "differs from the buffered one")
            del sel
        runs = {
            "ivf_score_topk_dedup": (
                (vals, ids), (rvals, rids),
                lambda: ops.ivf_score_topk_dedup(*ded, k, scales=sc),
                lambda: ref.ref_ivf_score_topk_dedup(*ded, k, sc), 0),
            "ivf_score_topk_dedup_rows": (
                (vals, ids), (rvals, rids),
                lambda: ops.ivf_score_topk_dedup_rows(*ded, gpv, gpf, k,
                                                      scales=sc),
                lambda: ref.ref_ivf_score_topk_dedup_rows(*ded, gpv, gpf, k,
                                                          sc),
                d + M),
            "ivf_score_topk_batch": (
                (bv, bi), (rbv, rbi),
                lambda: ops.ivf_score_topk_batch(*grp, probes, q_t, k,
                                                 scales=sc),
                lambda: ref.ref_ivf_score_topk_batch(*grp, probes, q_t, k,
                                                     sc),
                0),
        }
        atol = (L2_ATOL + depth_atol(q_t, be.grouped.reshape(-1, d), d)
                if depth else torch.full((B, 1), L2_ATOL, device=dev))
        for base, (got, want, kernel, plain_fn, row_floats) in runs.items():
            name = base + suffix
            wv = want[0][:, :k]
            live = ~torch.isneginf(wv)
            tol_all = atol + L2_RTOL * wv.abs()
            err = (got[0] - wv)[live].abs().max().item()
            tol = tol_all[live].max().item()
            check(bool(((got[0] - wv).abs() <= tol_all)[live].all()),
                  f"{name} k={k} error {err} past its slot's tolerance")
            agree, total = ids_outside_ties(want[0], want[1], got[1], L2_RTOL,
                                            atol.cpu().numpy())
            check(agree == total, f"{name} k={k}: {total - agree} ids differ "
                  "outside near-ties")
            ms = time_ms(kernel, 20)
            plain = time_ms(plain_fn, 3)
            bnd, by, real, padded = ivf_bound(be, uniq, member, B, k,
                                              row_floats)
            split = ""
            if base != "ivf_score_topk_batch":   # B5's and B6's kernels
                split = "; by kernel, device ms: " + ", ".join(
                    f"{n} {t:.4f}" for n, t in kernel_split(kernel).items())
            print(f"[kernel] {name} b={B} nlist={NLIST} max_list="
                  f"{be.max_list} d={d} nprobe={NPROBE} k={k}: max_abs_err "
                  f"{err:.3g} (tolerance up to {tol:.3g}) ids {agree}/{total} "
                  "outside near-ties; "
                  f"kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms "
                  f"{bnd:.4f} ({by}; probed lists {real / 1e6:.1f} MB of "
                  f"real rows, {padded / 1e6:.1f} MB padded){split}")
            if k == ks[0]:    # the main path's default width goes in the line
                res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                 bound_ms=bnd, bound_by=by, library_ms=None)
            else:
                res[name]["max_abs_err"] = max(err, res[name]["max_abs_err"])
    print(f"[ivf-kernel] B6{suffix} (vals, ids) bit-equal to B5{suffix}'s "
          f"and its rows bit-equal to the gathered rows at k in {ks}, "
          f"d={d}; the selection path bit-equal to the buffered one where "
          f"both plan; card {power}")
    return res


def phase_ivf(dev, power: str, inp: Inputs, flat_recall: float):
    """The IVF path at SIFT1M scale; returns the IVF kernels' results, the
    launch counts of its build and serving (the kernel checks between them
    are not counted), recall@10 and the index as built."""
    cfg = fcvi.FCVIConfig(backend="ivf", nlist=NLIST, nprobe=NPROBE)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    index = fcvi.build(inp.corpus.vectors, inp.corpus.filters, cfg,
                       device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    be = index.backend
    t0 = time.perf_counter()
    clustering.kmeans(be.vectors, NLIST, iters=15,
                      generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0
    sizes = be.list_sizes.double()
    pad = 1.0 - N / (NLIST * be.max_list)
    slab_mb = (be.grouped.nbytes + be.grouped_sq.nbytes
               + be.valid.nbytes) / 1e6
    print(f"[ivf] build on the card {build_s:.2f} s (k-means nlist={NLIST} "
          f"iters=15 alone, same inputs: {kmeans_s:.2f} s); max_list "
          f"{be.max_list}, mean list {sizes.mean().item():.1f}, smallest "
          f"{int(sizes.min().item())}, pad fraction {pad:.3f}; serving slabs "
          f"{slab_mb:.0f} MB, grouped payloads "
          f"{4 * NLIST * be.max_list * (D + M) / 1e6:.0f} MB; card {power}")
    res = ivf_kernels(index, inp.q_all[:B], inp.f_all[:B], dev, power)
    torch.cuda.empty_cache()

    state0 = fcvi.index_state(index)
    eng = engine_mod.FCVIEngine(index, engine_mod.EngineConfig(), device=dev)
    _build.reset_launch_counts()
    scores, ids = serve("ivf", eng, inp, power)
    qv, qf = (torch.tensor(a, device=dev) for a in (inp.q_all[:B],
                                                    inp.f_all[:B]))
    fcvi.query(eng.index, qv, qf, 10)
    ib = eng.index.backend
    q_t = eng.index.transform.apply(qv, qf).contiguous()
    c2 = torch.sum(ib.centroids * ib.centroids, dim=-1)
    probes = ops.score_topk(ib.centroids, c2, q_t, NPROBE)[1]
    vals, _ = ops.ivf_score_topk_batch(ib.grouped, ib.grouped_sq, ib.valid,
                                       probes, q_t, KP)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(vals).all()), "ivf_score_topk_batch on the "
          "index's slabs returned non-finite scores")
    for name, n in _build.launch_counts().items():
        counts[name] = counts.get(name, 0) + n
    print(f"[ivf] counts {json.dumps(counts)}")

    recall = recall_vs_truth(index, state0, inp, ids, dev)
    print(f"[ivf] recall@10 {recall:.4f} over 512 queries (flat path "
          f"{flat_recall:.4f}; before the list scan's redesign "
          f"{IVF_RECALL_BEFORE['ivf']:.4f}); card {power}")
    check(abs(recall - IVF_RECALL_BEFORE["ivf"]) < 1e-4, "IVF recall@10 "
          f"{recall:.4f} differs from {IVF_RECALL_BEFORE['ivf']:.4f}")
    qb, fb = inp.q_all[:B], inp.f_all[:B]
    ties = probe_ties(be.centroids, index.transform.apply(qv, qf), NPROBE)
    print(f"[ivf] {int(ties.sum())} of {B} first-batch queries at a probe "
          "near-tie")
    against_cpu_engine("ivf", index, state0, scores[:B], ids[:B], qb, fb,
                       ties)

    # full probe scans every row: the flat engine's top-10 on the same
    # corpus and state, queries at either engine's escalation boundary
    # left out
    full = dataclasses.replace(index, config=dataclasses.replace(
        cfg, nprobe=NLIST))
    flat_ix = dataclasses.replace(index, config=fcvi.FCVIConfig(),
                                  backend=flat_mod.build(be.vectors))
    engs = [engine_mod.FCVIEngine(ix, engine_mod.EngineConfig(), device=dev)
            for ix in (full, flat_ix)]
    (fs, fi), (ls, li) = (e.search(qb, fb) for e in engs)
    edge = np.zeros(B, bool)
    for e in engs:
        edge |= np.abs(margins(e, qb, fb) - e.cfg.escalate_margin) < 1e-5
    same_top10(f"ivf nprobe={NLIST} vs flat engine", fs, fi, ls, li, edge)
    return res, counts, recall, index


def candidate_ties(be, q_t, kp, window: int = 64):
    """((b,) bool, (b,) bool): queries whose kp-th and (kp+1)-th ADC scores
    lie within the L2 tolerance, and those of them where the rows within
    the tolerance of that boundary do not all carry the same combined
    codes. Rows with equal codes score the same on every device and go by
    row id, so only the second kind may give the card and the CPU
    candidate sets that differ by a row."""
    v, i = pq_mod.search(be, q_t, kp + window)
    v = v.double().cpu().numpy()
    i = i.long().cpu().numpy()
    s, t = v[:, kp - 1], v[:, kp]
    tol = L2_ATOL + L2_RTOL * np.abs(t)
    near = ((np.abs(v - s[:, None]) <= tol[:, None])
            | (np.abs(v - t[:, None]) <= tol[:, None]))
    tie = (s - t) <= tol
    mixed = np.zeros_like(tie)
    codes = be.ccodes.cpu().numpy()
    for r in np.nonzero(tie)[0]:
        rows = codes[i[r][near[r]]]
        mixed[r] = near[r, -1] or not (rows == rows[0]).all()
    return tie, mixed


def pq_check(name, got, want, shape) -> float:
    """Largest error of a PQ kernel against its plain version; raises where
    a slot lies past its own L2 tolerance (atol 1e-4 + rtol 1e-5 of the
    plain value)."""
    err = (got - want).abs().max().item()
    share = tol_share(got, want)
    check(share <= 1.0, f"{name} {shape} error {err}: {share:.3f} of its "
          "slot's tolerance")
    return err


def pq_kernels(be, q_t, power: str) -> dict:
    """B8, B9 and B10 against their plain versions on the built index's
    codebooks and combined codes and the first timed batch's LUTs, and the
    first-occurrence top-k of that batch's (64, n) ADC distances."""
    m, ksub, dsub = be.codebooks.shape
    n = be.size
    res = {}
    qs = q_t.reshape(B, m, dsub).contiguous()
    got = ops.pq_lut_qdot(qs, be.codebooks)
    err = pq_check("pq_lut_qdot", got, ref.ref_pq_lut_qdot(qs, be.codebooks),
                   (B, m, dsub, ksub))
    ms = time_ms(lambda: ops.pq_lut_qdot(qs, be.codebooks), 50)
    dev_ms = device_time(lambda: ops.pq_lut_qdot(qs, be.codebooks))[0]
    plain = time_ms(lambda: ref.ref_pq_lut_qdot(qs, be.codebooks), 50)
    lib = time_ms(lambda: torch.einsum("qmd,mkd->qmk", qs, be.codebooks), 50)
    bnd, by = bound_ms(4 * (B * m * dsub + m * ksub * dsub + B * m * ksub),
                       2 * B * m * ksub * dsub)
    print(f"[kernel] pq_lut_qdot ({B},{m},{dsub})x({m},{ksub},{dsub}): "
          f"max_abs_err {err:.3g} kernel_ms {ms:.4f} (device {dev_ms:.4f}) "
          f"plain_ms {plain:.4f} library_ms(einsum) {lib:.4f} bound_ms "
          f"{bnd:.5f} ({by}); card {power}")
    res["pq_lut_qdot"] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                              plain_ms=plain, bound_ms=bnd, bound_by=by,
                              library_ms=lib)
    res.update(scan_luts_kernel(be, q_t, power))

    luts = pq_mod.scan_luts(be, q_t)
    kk = luts.shape[-1]
    codes = be.ccodes
    pos = codes.long() + kk * torch.arange(m, device=codes.device)
    for b in (B, B_ESC):
        lb = luts[:b].contiguous()
        w = lb.permute(1, 2, 0).reshape(m * kk, b).contiguous()
        got = ops.pq_score_batch(codes, lb)
        want = ref.ref_pq_score_batch(codes, lb)
        err = pq_check("pq_score_batch", got, want, (n, m, b, kk))
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"pq_score_batch b={b} is not bit-equal to its plain version")
        lib_out = torch.nn.functional.embedding_bag(pos, w, mode="sum")
        lib_err = (lib_out.T - want).abs().max().item()
        ms = time_ms(lambda: ops.pq_score_batch(codes, lb))
        dev_ms, split, _ = device_time(lambda: ops.pq_score_batch(codes, lb))
        relayout = sum(t for name, t in split.items() if "relayout" in name)
        plain = time_ms(lambda: ref.ref_pq_score_batch(codes, lb), 3)
        lib = time_ms(lambda: torch.nn.functional.embedding_bag(
            pos, w, mode="sum"))
        bnd, by = bound_ms(codes.nbytes + lb.nbytes + 4 * b * n, b * n * m)
        print(f"[kernel] pq_score_batch codes ({n},{m}) int32, luts "
              f"({b},{m},{kk}): max_abs_err {err:.3g} (bit-equal) kernel_ms "
              f"{ms:.4f} (device {dev_ms:.4f}, the LUT relayout "
              f"{relayout:.4f} of it) plain_ms {plain:.4f} "
              f"library_ms(embedding_bag) {lib:.4f} (its error {lib_err:.3g};"
              f" the kernel faster: {ms < lib}) bound_ms {bnd:.4f} ({by}); "
              f"step 0 (PERF.md) {B9_STEP0[b]:.4f}; card {power}")
        if b == B:
            res["pq_score_batch"] = dict(max_abs_err=err, ms=ms,
                                         device_ms=dev_ms, plain_ms=plain,
                                         bound_ms=bnd, bound_by=by,
                                         library_ms=lib)
            d2 = got
        else:
            res["pq_score_batch"]["max_abs_err"] = max(
                err, res["pq_score_batch"]["max_abs_err"])
        del got, want, lib_out

    lut = luts[0].contiguous()
    w = lut.reshape(m * kk, 1)
    got = ops.pq_score(codes, lut)
    err = pq_check("pq_score", got, ref.ref_pq_score(codes, lut), (n, m, kk))
    check(torch.equal(got.view(torch.int32),
                      ref.ref_pq_score(codes, lut).view(torch.int32)),
          "pq_score is not bit-equal to its plain version")
    ms = time_ms(lambda: ops.pq_score(codes, lut), 20)
    dev_ms = device_time(lambda: ops.pq_score(codes, lut))[0]
    plain = time_ms(lambda: ref.ref_pq_score(codes, lut), 5)
    lib = time_ms(lambda: torch.nn.functional.embedding_bag(pos, w,
                                                            mode="sum"), 20)
    bnd, by = bound_ms(codes.nbytes + lut.nbytes + 4 * n, n * m)
    print(f"[kernel] pq_score codes ({n},{m}), lut ({m},{kk}): max_abs_err "
          f"{err:.3g} (bit-equal) kernel_ms {ms:.4f} (device {dev_ms:.4f}; "
          f"step 0 (PERF.md) {B10_STEP0[0]:.4f}, device {B10_STEP0[1]:.4f}) "
          f"plain_ms {plain:.4f} library_ms(embedding_bag) {lib:.4f} "
          f"bound_ms {bnd:.4f} ({by}); card {power}")
    res["pq_score"] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                           plain_ms=plain, bound_ms=bnd, bound_by=by,
                           library_ms=lib)
    del pos

    # the candidate selection after B9 (lax.top_k in the reference)
    neg = -d2
    for k in (KP, 4 * KP):
        vals, idx = ref.topk_first_packed(neg, k)
        sv, si = ref.topk_first(neg, k)
        check(torch.equal(vals, sv) and torch.equal(idx, si),
              f"packed top-{k} differs from the stable sort")
        t_packed = time_ms(lambda: ref.topk_first_packed(neg, k), 10)
        t_sort = time_ms(lambda: ref.topk_first(neg, k), 3)
        t_topk = time_ms(lambda: torch.topk(neg, k), 10)
        print(f"[pq] first-occurrence top-{k} of ({B},{n}): packed-key topk "
              f"{t_packed:.4f} ms (equal to the stable sort, "
              f"{t_sort:.4f} ms; torch.topk alone, no tie rule, "
              f"{t_topk:.4f} ms); card {power}")
    del d2, neg
    torch.cuda.empty_cache()
    res.update(pq_topk_kernels(be, luts, power))
    return res


def chain_luts(be, queries):
    """The scan LUT as B8 and a chain of plain torch ops, nine launches
    (``index.pq.scan_luts`` before ``ops.pq_scan_luts``): timed as what the
    one kernel replaced; the port never calls it."""
    q = queries.shape[0]
    m, ksub, dsub = be.codebooks.shape
    q_dot = ops.pq_lut_qdot(queries.reshape(q, m, dsub).contiguous(),
                            be.codebooks)
    qres = queries[:, None, :] - be.coarse_centers[None]
    qres_sq = torch.sum(qres.reshape(q, be.ncoarse, m, dsub) ** 2,
                        dim=-1).transpose(1, 2)
    luts = (qres_sq[..., None]
            - 2.0 * (q_dot[:, :, None, :]
                     - be.coarse_dot.transpose(0, 1)[None])
            + be.cb_sq[None, :, None, :])
    return luts.reshape(q, m, -1).contiguous()


def scan_luts_kernel(be, q_t, power: str) -> dict:
    """``ops.pq_scan_luts`` bit for bit against its plain version at b=64,
    16 and 1 on the index's codebooks, centres and build terms, timed (host
    loop, device) beside its bound (the table written once, the inputs
    read once, or its fp32 operations), the plain version and the chain
    of launches it replaced (``chain_luts``)."""
    m, ksub, dsub = be.codebooks.shape
    c = be.ncoarse
    terms = (be.codebooks, be.coarse_centers, be.coarse_dot, be.cb_sq)
    res = {}
    for b in (B, B_ESC, 1):
        qb = q_t[:b].contiguous()
        got = ops.pq_scan_luts(qb, *terms)
        want = ref.ref_pq_scan_luts(qb, *terms)
        check(got.shape == (b, m, c * ksub) and torch.equal(
            got.view(torch.int32), want.view(torch.int32)),
              f"pq_scan_luts b={b} is not bit-equal to its plain version")
        old = chain_luts(be, qb)
        share = tol_share(got, old)
        check(share <= 1.0, f"pq_scan_luts b={b}: {share:.3f} of the L2 "
              "tolerance from the chain it replaced")
        ms = time_ms(lambda: ops.pq_scan_luts(qb, *terms), 50)
        dev_ms, _, n_launch = device_time(lambda: ops.pq_scan_luts(qb,
                                                                  *terms))
        ms_old = time_ms(lambda: chain_luts(be, qb), 50)
        dev_old, _, n_old = device_time(lambda: chain_luts(be, qb))
        plain = time_ms(lambda: ref.ref_pq_scan_luts(qb, *terms), 10)
        bnd, by = bound_ms(
            got.nbytes + qb.nbytes + sum(t.nbytes for t in terms),
            b * m * ksub * (2 * dsub + 4 * c) + b * c * m * 3 * dsub)
        h0, d0 = LUTS_STEP0[b]
        print(f"[kernel] pq_scan_luts b={b} M={m} ncoarse={c} ksub={ksub} "
              f"dsub={dsub}: bit-equal to its plain version ({share:.3f} of "
              f"the L2 tolerance from the chain it replaced); host loop "
              f"{ms:.4f} ms, device {dev_ms:.4f} ({n_launch:g} launch); the "
              f"chain (B8 + torch ops): host loop {ms_old:.4f}, device "
              f"{dev_old:.4f} ({n_old:g} launches); step 0 (PERF.md) "
              f"{h0:.4f} / {d0:.4f}; plain_ms {plain:.4f} bound_ms "
              f"{bnd:.5f} ({by}); card {power}")
        if b == B:   # the table's order moves no candidate past a near-tie
            for kp in (KP, 4 * KP):
                new = ops.pq_score_topk(be.ccodes, got, kp, be.grouped)
                chain = ops.pq_score_topk(be.ccodes, old, kp + 1,
                                          be.grouped)
                agree, total = ids_outside_ties(chain[0], chain[1], new[1],
                                                L2_RTOL, L2_ATOL)
                check(agree == total, f"pq_scan_luts k'={kp}: {total - agree}"
                      " candidates differ from the chain's outside near-ties")
                print(f"[kernel] pq_scan_luts k'={kp}: ADC candidates "
                      f"{agree}/{total} equal to the chain's outside its "
                      "near-ties")
            res["pq_scan_luts"] = dict(max_abs_err=0.0, ms=ms,
                                       device_ms=dev_ms, plain_ms=plain,
                                       bound_ms=bnd, bound_by=by,
                                       library_ms=None)
        del got, want, old
    return res


def smem_floor_ms(lookups: float) -> float:
    """The least time for ``lookups`` 4-byte shared-memory reads on this
    card: every SM reading SMEM_BYTES_CLK bytes a clock at its largest SM
    clock (``nvidia-smi clocks.max.sm``)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * 4 * lookups / (sms * SMEM_BYTES_CLK * mhz * 1e6)


def topk_split(split: dict) -> str:
    """A fused PQ call's device ms by kernel, named by stage."""
    stage = (("relayout", "relayout"), ("sample", "sample"),
             ("threshold", "threshold"), ("pq_topk", "scan"),
             ("merge", "merge"), ("sel_pass", "select passes"),
             ("pq_select", "select finish"))
    out = []
    for name, t in split.items():
        tag = next((v for k, v in stage if k in name), name)
        out.append(f"{tag} {t:.4f}")
    return ", ".join(out)


def pq_topk_kernels(be, luts, power: str) -> dict:
    """The serving path's fused ADC scan + top-k (``ops.pq_score_topk``)
    bit-equal to its plain version at kk = 80, 320 and 2048 (EngineConfig(
    k=64)'s escalated k'), at b=64 and an escalation sub-batch's b=16, by
    the planner's path and with each path forced (the buffered one where
    its buffers fit); timed beside its bound (bytes) and its floor (the
    shared-memory lookups), its time before the redesign, the plain
    version, the path it replaced (B9 + the packed-key top-k) and the
    library pair (embedding_bag + the same top-k); each call split into its
    kernels (relayout, sample, threshold, scan, merge, or the select), with
    the words admitted a query and the cuts of pass 1 (``_stats``)."""
    m, kk_all = luts.shape[1], luts.shape[2]
    n = be.size
    codes = be.ccodes
    pos = codes.long() + kk_all * torch.arange(m, device=codes.device)
    gcodes, gids, goff, _ = be.grouped
    ksub = be.codebooks.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
    for b in (B, B_ESC):
        lb = luts[:b].contiguous()
        w = lb.permute(1, 2, 0).reshape(m * kk_all, b).contiguous()
        floor = smem_floor_ms(b * n * m)
        for kk in (KP, 4 * KP, 2048):
            got = ops.pq_score_topk(codes, lb, kk, be.grouped)
            want = ref.ref_pq_score_topk(codes, lb, kk)
            check(bits_equal(got, want),
                  f"pq_score_topk b={b} kk={kk} differs from its plain version")
            plan = pq_lut.topk_plan(n, b, kk, m, ksub, sms)
            ms = time_ms(lambda: ops.pq_score_topk(codes, lb, kk, be.grouped))
            _, split, _ = device_time(
                lambda: ops.pq_score_topk(codes, lb, kk, be.grouped))
            plain = time_ms(lambda: ref.ref_pq_score_topk(codes, lb, kk), 3)
            old = time_ms(lambda: ref.topk_first_packed(
                -ops.pq_score_batch(codes, lb), kk), 5)
            pair = time_ms(lambda: ref.topk_first_packed(
                -torch.nn.functional.embedding_bag(pos, w, mode="sum").T,
                kk), 5)
            bnd, by = bound_ms(gcodes.nbytes + gids.nbytes + goff.nbytes
                               + lb.nbytes + 8 * b * kk, b * n * m)
            before = (f"; before the redesign (PERF.md) "
                      f"{TOPK_STEP0[kk]:.4f}" if b == B else "")
            print(f"[kernel] pq_score_topk b={b} n={n} M={m} kk={kk} "
                  f"({'selection' if plan.select else 'buffered'} path, bq "
                  f"{plan.bq}, {plan.nchunks} chunks, cap {plan.cap}, "
                  f"sample {plan.sample}): bit-equal to its plain version; "
                  f"kernel_ms {ms:.4f}{before}; by kernel, device ms: "
                  f"{topk_split(split)}; plain_ms {plain:.4f} bound_ms "
                  f"{bnd:.4f} ({by}), shared-memory floor {floor:.4f} ms "
                  f"({b * n * m / 1e6:.0f}M 4-byte lookups); replaced path "
                  f"(pq_score_batch + packed top-k) {old:.4f} ms; library "
                  f"pair (embedding_bag + packed top-k) {pair:.4f} ms; card "
                  f"{power}")
            if b == B and kk == KP:
                res["pq_score_topk"] = dict(max_abs_err=0.0, ms=ms,
                                            plain_ms=plain, bound_ms=bnd,
                                            bound_by=by, library_ms=None)
            ms_path = {}
            for forced in (True, False):   # both paths, forced, bit-equal
                try:
                    fp = pq_lut.topk_plan(n, b, kk, m, ksub, sms, forced)
                except ValueError:       # the buffers do not fit
                    continue
                alt = pq_lut.pq_score_topk(*be.grouped, lb, kk,
                                           _select=forced)
                check(bits_equal(alt, want), f"pq_score_topk (select="
                      f"{forced}) differs at b={b} kk={kk}")
                ms_path[forced] = time_ms(lambda: pq_lut.pq_score_topk(
                    *be.grouped, lb, kk, _select=forced))
                if forced:
                    continue
                stats = torch.zeros(pq_lut.STATS, dtype=torch.int64,
                                    device=lb.device)
                pq_lut.pq_score_topk(*be.grouped, lb, kk, _select=False,
                                     _stats=stats)
                st = dict(zip(pq_lut.STAT_NAMES, stats.tolist()))
                print(f"[pq-topk] buffered b={b} kk={kk} (bq {fp.bq}, "
                      f"{fp.nchunks} chunks, cap {fp.cap}, tile {fp.tile}, "
                      f"sample {fp.sample}): words admitted a query "
                      f"{st['admitted'] / b:.1f} (a query a chunk "
                      f"{st['admitted'] / max(st['query_chunks'], 1):.2f}), "
                      f"cuts {st['cuts']} ({st['cuts'] / b:.2f} a query, "
                      f"{st['cut_words'] / max(st['cuts'], 1):.1f} words a "
                      f"cut); card {power}")
            print(f"[kernel] pq_score_topk b={b} kk={kk} both paths forced, "
                  f"bit-equal: selection {ms_path[True]:.4f} ms, buffered "
                  + (f"{ms_path[False]:.4f} ms" if False in ms_path
                     else "(its buffers do not fit)") + f"; card {power}")
            if b == B and kk == 2048:
                res["pq_score_topk_select"] = dict(
                    max_abs_err=0.0, ms=ms_path[True], plain_ms=plain,
                    bound_ms=bnd, bound_by=by, library_ms=None)
            del got, want
        torch.cuda.empty_cache()
    return res


def bits_equal(a, b) -> bool:
    """(vals, ids) pairs equal bit for bit (-0.0 apart from +0.0)."""
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


def phase_pq(dev, power: str, inp: Inputs, flat_recall: float,
             ivf_recall: float):
    """The PQ path at SIFT1M scale with every FCVIConfig default but the
    backend; returns the PQ kernels' results, the launch counts of its
    build and serving (the kernel checks between them are not counted) and
    the index as built (phase 3g serves it again)."""
    cfg = fcvi.FCVIConfig(backend="pq")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    index = fcvi.build(inp.corpus.vectors, inp.corpus.filters, cfg,
                       device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    be = index.backend
    # the k-means alone, on the same inputs and the same draws' order
    x = index.transform.apply_normalized(index.vectors_n, index.filters_n)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    centers, labels = clustering.kmeans(x, cfg.pq_coarse, iters=15,
                                        generator=gen)
    torch.cuda.synchronize()
    coarse_s = time.perf_counter() - t0
    sub = (x - centers[labels]).reshape(N, cfg.pq_m, -1)
    t0 = time.perf_counter()
    for j in range(cfg.pq_m):
        clustering.kmeans(sub[:, j, :].contiguous(), cfg.pq_ksub, iters=15,
                          generator=gen)
    torch.cuda.synchronize()
    sub_s = time.perf_counter() - t0
    del x, sub, centers, labels
    print(f"[pq] build on the card {build_s:.2f} s (k-means alone, same "
          f"inputs: coarse {cfg.pq_coarse} centers {coarse_s:.2f} s, "
          f"{cfg.pq_m} subspaces x {cfg.pq_ksub} codewords {sub_s:.2f} s); "
          f"codes {tuple(be.codes.shape)} {be.codes.dtype} "
          f"{be.codes.nbytes / 1e6:.1f} MB, coarse ids "
          f"{be.coarse_ids.nbytes / 1e6:.1f} MB, combined codes "
          f"{be.ccodes.nbytes / 1e6:.1f} MB, re-rank originals "
          f"{(index.vectors_n.nbytes + index.filters_n.nbytes) / 1e6:.0f} MB; "
          f"card {power}")
    qv, qf = (torch.tensor(a, device=dev) for a in (inp.q_all[:B],
                                                    inp.f_all[:B]))
    q_t = index.transform.apply(qv, qf).contiguous()
    res = pq_kernels(be, q_t, power)
    torch.cuda.empty_cache()
    (t1, m1), (t4, m4) = (candidate_ties(be, q_t, kp) for kp in (KP, 4 * KP))
    ties = m1 | m4
    print(f"[pq] {int((t1 | t4).sum())} of {B} first-batch queries at a "
          f"candidate near-tie (k'={KP} or {4 * KP}); {int(ties.sum())} of "
          "them between rows whose combined codes differ (left out below)")

    state0 = fcvi.index_state(index)
    eng = engine_mod.FCVIEngine(index, engine_mod.EngineConfig(), device=dev)
    _build.reset_launch_counts()
    scores, ids = serve("pq", eng, inp, power)
    fcvi.query(eng.index, qv, qf, 10)
    torch.cuda.synchronize()
    run = _build.launch_counts()
    check(run.get("pq_score_batch", 0) == 0 and run.get("pq_score_topk", 0),
          f"pq serving did not go through the fused scan alone: {run}")
    check(run.get("pq_lut_qdot", 0) == 0 and run.get("pq_scan_luts", 0),
          f"pq serving did not build its LUTs through pq_scan_luts: {run}")
    print(f"[pq] serving run: pq_score_topk {run['pq_score_topk']} "
          f"launches, pq_score_batch {run.get('pq_score_batch', 0)} (the "
          "(b, n) distances are never written); pq_scan_luts "
          f"{run['pq_scan_luts']}, pq_lut_qdot {run.get('pq_lut_qdot', 0)}")
    # B8, B9 and B10 are off every serving path (the reference's serving
    # path does not call B10 either): one direct call each on the index
    _build.reset_launch_counts()
    ib = eng.index.backend
    q1 = eng.index.transform.apply(qv, qf)
    one = pq_mod.scan_luts(ib, q1)
    m1, _, dsub1 = ib.codebooks.shape
    cross = ops.pq_lut_qdot(q1.reshape(B, m1, dsub1).contiguous(),
                            ib.codebooks)
    check(bool(torch.isfinite(cross).all()), "pq_lut_qdot on the index's "
          "codebooks returned non-finite values")
    d2 = ops.pq_score(ib.ccodes, one[0])
    d2b = ops.pq_score_batch(ib.ccodes, one)
    torch.cuda.synchronize()
    check(d2.shape == (ib.size,) and bool(torch.isfinite(d2).all())
          and torch.equal(d2b[0], d2),
          "pq_score on the index's codes returned non-finite distances")
    del d2b
    for name, n in (*run.items(), *_build.launch_counts().items()):
        counts[name] = counts.get(name, 0) + n
    print(f"[pq] counts {json.dumps(counts)}")

    recall = recall_vs_truth(index, state0, inp, ids, dev)
    print(f"[pq] recall@10 {recall:.4f} over 512 queries (flat path "
          f"{flat_recall:.4f}, IVF {ivf_recall:.4f}; before pq_scan_luts "
          f"{PQ_RECALL_BEFORE:.4f}); card {power}")
    sweep = []
    for kp in (KP, 4 * KP, 16 * KP):   # the default k', escalated, wider
        kp_ids = np.concatenate([fcvi.query(
            index, torch.tensor(inp.q_all[s:s + B], device=dev),
            torch.tensor(inp.f_all[s:s + B], device=dev), 10,
            k_prime=kp)[1].cpu().numpy() for s in range(0, 512, B)])
        r = recall_vs_truth(index, state0, inp, kp_ids, dev)
        sweep.append(f"k'={kp} {r:.4f}")
    print(f"[pq] recall@10 of fcvi.query (no escalation) by k': "
          f"{', '.join(sweep)}")
    ci = against_cpu_engine("pq", index, state0, scores[:B], ids[:B],
                            inp.q_all[:B], inp.f_all[:B], ties)
    same = (ci == ids[:B]).all(axis=1)
    print(f"[pq] of the {int(ties.sum())} queries left out, "
          f"{int(same[ties].sum())} have the CPU engine's top-10 ids all the "
          "same anyway")
    return res, counts, index


def stored_bytes(be) -> str:
    """The bytes a flat or IVF backend keeps on the card, by array."""
    parts = [("rows", be.vectors), ("scales", be.scales),
             ("sq_norms", be.sq_norms)]
    if hasattr(be, "grouped"):
        parts += [("grouped slabs", be.grouped),
                  ("grouped scales", be.grouped_scales),
                  ("grouped_sq", be.grouped_sq), ("valid", be.valid)]
    return ", ".join(f"{name} {t.nbytes / 1e6:.1f} MB" for name, t in parts
                     if t is not None)


def flat_variant_kernels(index, q_t, power: str) -> dict:
    """The index's variants of B2 and B3 (its storage dtype, its scales)
    against their plain versions on its stored rows, with the payloads the
    engine carries and the first timed batch's transformed queries, at
    kk=88 and 328."""
    be = index.backend
    x, sq, sc = be.vectors, be.sq_norms, be.scales
    suffix = SUFFIX[index.config.storage_dtype]
    pv, pf = index.vectors_n, index.filters_n
    scan_in = (x.nbytes + sq.nbytes + (0 if sc is None else sc.nbytes)
               + q_t.nbytes)
    res = {}
    for kk in (88, 328):
        vals, ids = ops.score_topk(x, sq, q_t, kk, scales=sc)
        rvals, rids = ref.ref_score_topk(x, sq, q_t, kk + 1, sc)
        err = (vals - rvals[:, :kk]).abs().max().item()
        agree, total = ids_outside_ties(rvals, rids, ids, L2_RTOL, L2_ATOL)
        name, name_rows = "score_topk" + suffix, "score_topk_rows" + suffix
        share = tol_share(vals, rvals[:, :kk])
        e64, p64 = fp64_errs(x, sq, q_t, vals, ids, sc)
        check(share <= 1.0, f"{name} kk={kk} error {err}: {share:.3f} of "
              "its slot's tolerance")
        check(agree == total, f"{name} kk={kk}: {total - agree} ids differ "
              "outside near-ties")
        out = ops.score_topk_rows(x, sq, pv, pf, q_t, kk, scales=sc)
        check(torch.equal(out[0], vals) and torch.equal(out[1], ids),
              f"{name_rows} (vals, ids) differ from {name}'s")
        idx = ids.long()
        rows = x[idx].to(torch.float32)
        if sc is not None:
            rows = rows * sc[idx][..., None]
        check(torch.equal(out[2], rows) and torch.equal(out[3], pv[idx])
              and torch.equal(out[4], pf[idx]),
              f"{name_rows} rows differ from the plain dequantized rows")
        ms = time_ms(lambda: ops.score_topk(x, sq, q_t, kk, scales=sc))
        ms_rows = time_ms(lambda: ops.score_topk_rows(x, sq, pv, pf, q_t, kk,
                                                      scales=sc))
        plain = time_ms(lambda: ref.ref_score_topk(x, sq, q_t, kk, sc), 5)
        plain_rows = time_ms(
            lambda: ref.ref_score_topk_rows(x, sq, pv, pf, q_t, kk, sc), 5)
        pair = pair_ms(x, sq, q_t, kk, sc)
        bnd, by, unit = scan_bound_ms(scan_in + 8 * B * kk, B * N, D,
                                      x.dtype)
        rows_bytes = 4 * B * kk * (2 * (D + M) + D)
        bnd_rows, by_rows, _ = scan_bound_ms(
            scan_in + 8 * B * kk + rows_bytes, B * N, D, x.dtype)
        print(f"[kernel] {name} b={B} n={N} d={D} {x.dtype} kk={kk}: "
              f"max_abs_err {err:.3g} ({share:.3f} of the tolerance; against "
              f"fp64 the scan {e64:.3g}, the plain version {p64:.3g}) ids "
              f"{agree}/{total} outside near-ties; "
              f"kernel_ms {ms:.4f} plain_ms {plain:.4f} pair_ms {pair:.4f} "
              f"bound_ms {bnd:.4f} ({by}, {unit}); card {power}")
        print(f"[kernel] {name_rows} kk={kk}: (vals, ids) = {name}'s, rows "
              f"exact; kernel_ms {ms_rows:.4f} plain_ms {plain_rows:.4f} "
              f"pair_ms {pair:.4f} bound_ms {bnd_rows:.4f} ({by_rows}); card "
              f"{power}")
        if kk == 88:  # the main path's default width goes in the JSON line
            res[name] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                             library_ms=None)
            res[name_rows] = dict(ms=ms_rows, plain_ms=plain_rows,
                                  bound_ms=bnd_rows, bound_by=by_rows,
                                  library_ms=None)
        for n in (name, name_rows):
            res[n]["max_abs_err"] = max(err, res[n].get("max_abs_err", 0.0))
        del vals, ids, rvals, rids, out, rows
    return res


def phase_storage_flat(dev, power: str, inp: Inputs, flat_ids):
    """Phase 3d: flat at bf16 and at int8. Returns the B2/B3 variants'
    results, the launch counts of the two builds and serving runs, and the
    two indexes as built."""
    res, counts, built = {}, {}, {}
    qv, qf = (torch.tensor(a, device=dev) for a in (inp.q_all[:B],
                                                    inp.f_all[:B]))
    for dtype in ("bfloat16", "int8"):
        tag = f"flat-{dtype}"
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        index = fcvi.build(inp.corpus.vectors, inp.corpus.filters,
                           fcvi.FCVIConfig(storage_dtype=dtype), device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        run = _build.launch_counts()
        print(f"[{tag}] build on the card {build_s:.2f} s; on the card: "
              f"{stored_bytes(index.backend)} (fp32 rows: "
              f"{4 * N * D / 1e6:.1f} MB); card {power}")
        res.update(flat_variant_kernels(
            index, index.transform.apply(qv, qf).contiguous(), power))
        torch.cuda.empty_cache()

        state0 = fcvi.index_state(index)
        eng = engine_mod.FCVIEngine(index, engine_mod.EngineConfig(),
                                    device=dev)
        _build.reset_launch_counts()
        scores, ids = serve(tag, eng, inp, power)
        check(eng._delta is None and eng.index.backend.vectors.dtype
              == index.backend.vectors.dtype, f"{tag}: compaction changed "
              "the storage dtype")
        fcvi.query(eng.index, qv, qf, 10)
        torch.cuda.synchronize()
        for name, n in _build.launch_counts().items():
            run[name] = run.get(name, 0) + n
        print(f"[{tag}] counts {json.dumps(run)}")
        for name, n in run.items():
            counts[name] = counts.get(name, 0) + n
        recall = recall_vs_truth(index, state0, inp, ids, dev)
        same = float((ids == flat_ids).all(axis=1).mean())
        print(f"[{tag}] recall@10 {recall:.4f} over 512 queries; top-10 equal "
              f"to the fp32 flat engine's for {same:.4f} of them; card "
              f"{power}")
        check(recall >= 0.9, f"{tag}: recall@10 {recall} below 0.9")
        against_cpu_engine(tag, index, state0, scores[:B], ids[:B],
                           inp.q_all[:B], inp.f_all[:B], np.zeros(B, bool))
        built["flat" + SUFFIX[dtype].replace("_", "-")] = index
        del eng, index, state0
        torch.cuda.empty_cache()
    return res, counts, built


def phase_storage_ivf(dev, power: str, inp: Inputs, ivf_recall: float):
    """Phase 3e: IVF at int8, and its lists' bf16 slabs. Returns the B5-B7
    variants' results, the launch counts of the build and both serving
    runs (the kernel checks between them are not counted), and the two
    indexes as built."""
    cfg = fcvi.FCVIConfig(backend="ivf", nlist=NLIST, nprobe=NPROBE,
                          storage_dtype="int8")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    index = fcvi.build(inp.corpus.vectors, inp.corpus.filters, cfg,
                       device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    be = index.backend
    print(f"[ivf-int8] build on the card {build_s:.2f} s; max_list "
          f"{be.max_list}; on the card: {stored_bytes(be)}; card {power}")
    res = ivf_kernels(index, inp.q_all[:B], inp.f_all[:B], dev, power)
    # bf16 slabs over the same lists, from the fp32 transformed corpus
    x_t = index.transform.apply_normalized(index.vectors_n, index.filters_n)
    half_be = ivf_mod.from_lists(x_t.to(torch.bfloat16), be.centroids,
                                 be.lists, be.list_sizes)
    del x_t
    half = dataclasses.replace(index, config=dataclasses.replace(
        cfg, storage_dtype="bfloat16"), backend=half_be)
    print(f"[ivf-bf16] the same lists at bf16; on the card: "
          f"{stored_bytes(half_be)}")
    res.update(ivf_kernels(half, inp.q_all[:B], inp.f_all[:B], dev, power))
    torch.cuda.empty_cache()

    qv, qf = (torch.tensor(a, device=dev) for a in (inp.q_all[:B],
                                                    inp.f_all[:B]))
    qb, fb = inp.q_all[:B], inp.f_all[:B]

    def direct_b7(ix):
        ib = ix.backend
        q_t = ix.transform.apply(qv, qf).contiguous()
        c2 = torch.sum(ib.centroids * ib.centroids, dim=-1)
        probes = ops.score_topk(ib.centroids, c2, q_t, NPROBE)[1]
        vals, _ = ops.ivf_score_topk_batch(ib.grouped, ib.grouped_sq,
                                           ib.valid, probes, q_t, KP,
                                           scales=ib.grouped_scales)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(vals).all()), "ivf_score_topk_batch on "
              f"the {ib.grouped.dtype} slabs returned non-finite scores")
        return q_t

    state0 = fcvi.index_state(index)
    eng = engine_mod.FCVIEngine(index, engine_mod.EngineConfig(), device=dev)
    _build.reset_launch_counts()
    scores, ids = serve("ivf-int8", eng, inp, power)
    check(eng.index.backend.grouped.dtype == torch.int8, "ivf-int8: "
          "compaction changed the storage dtype")
    fcvi.query(eng.index, qv, qf, 10)
    direct_b7(eng.index)
    for name, n in _build.launch_counts().items():
        counts[name] = counts.get(name, 0) + n
    del eng
    recall = recall_vs_truth(index, state0, inp, ids, dev)
    print(f"[ivf-int8] recall@10 {recall:.4f} over 512 queries (IVF fp32 "
          f"{ivf_recall:.4f}; before the list scan's redesign "
          f"{IVF_RECALL_BEFORE['ivf-int8']:.4f}); card {power}")
    check(abs(recall - IVF_RECALL_BEFORE["ivf-int8"]) < 1e-4, "IVF int8 "
          f"recall@10 {recall:.4f} differs from "
          f"{IVF_RECALL_BEFORE['ivf-int8']:.4f}")
    ties = probe_ties(be.centroids, index.transform.apply(qv, qf), NPROBE)
    print(f"[ivf-int8] {int(ties.sum())} of {B} first-batch queries at a "
          "probe near-tie")
    against_cpu_engine("ivf-int8", index, state0, scores[:B], ids[:B], qb, fb,
                       ties)
    del state0
    torch.cuda.empty_cache()

    # the bf16 slabs serve too: warm-up, one batch of 64, fcvi.query, B7
    hstate = fcvi.index_state(half)
    eng = engine_mod.FCVIEngine(half, engine_mod.EngineConfig(), device=dev)
    _build.reset_launch_counts()
    eng.search(inp.q_warm, inp.f_warm)
    hs, hi = eng.search(qb, fb)
    fcvi.query(half, qv, qf, 10)
    direct_b7(half)
    run = _build.launch_counts()
    for name, n in run.items():
        counts[name] = counts.get(name, 0) + n
    check(hs.shape == (B, 10) and np.isfinite(hs).all()
          and ((hi >= 0) & (hi < N)).all(), "ivf-bf16: results out of range")
    print(f"[ivf-bf16] counts {json.dumps(run)}; top-10 equal to the int8 "
          f"engine's for {float((hi == ids[:B]).all(axis=1).mean()):.4f} of "
          f"the first {B} queries")
    against_cpu_engine("ivf-bf16", half, hstate, hs, hi, qb, fb, ties)
    print(f"[3e] counts {json.dumps(counts)}")
    return res, counts, {"ivf-int8": index, "ivf-bf16": half}


# -- phase 3f: predicate search (the filter algebra) --------------------------

PREDICATES = {
    "P1": F.range("f7", 0.0, 0.6),                        # numeric, broad
    "P2": F.eq("f0", 1.0) & F.range("f7", 0.25, 0.75),    # category x band
    "P3": F.eq("f5", 1.0) & F.range("f7", 0.0, 0.1),      # selective
}
P4 = F.range("f7", 2.0, 3.0)                               # matches nothing
# a single-attribute band at P3's selectivity (0.0111): the fold plan takes
# one attribute, and at this selectivity asks for kp=4096 candidates
P3_FOLD = F.range("f7", 0.0, 0.0111)
K_MASK = 18                  # k + CANDIDATE_PAD: the mask/routed scan width
K_FOLD = 128                 # the fold plan's width at P1's selectivity


def eligibility(eng, pred) -> torch.Tensor:
    """(n,) bool rows of the engine's attribute table that ``pred``
    matches, evaluated on the card as the engine evaluates them."""
    cp = compile_predicate(pred, eng._attr_names)
    return eval_mask(eng._attrs, *cp.as_arrays(eng.device))


def folded(eng, pred, q: np.ndarray) -> torch.Tensor:
    """The queries folded to the predicate's raw target, as the engine
    folds them."""
    cp = compile_predicate(pred, eng._attr_names)
    return fcvi.fold_queries(eng.index, torch.tensor(q, device=eng.device),
                             cp.fold_target_raw(eng._col_means))


def dequantized(be) -> torch.Tensor:
    rows = be.vectors.double()
    return rows if be.scales is None else rows * be.scales.double()[:, None]


def filtered_oracle(rows, elig, q_t, k):
    """fp64 brute force over the eligible rows (b, k+1): (-d2 descending,
    row ids); rows (n, d) float64 dequantized."""
    ids = torch.nonzero(elig).flatten()
    x = rows[ids]
    q = q_t.double()
    d2 = ((q * q).sum(1)[:, None] - 2.0 * (q @ x.T)
          + (x * x).sum(1)[None, :])
    vals, pos = torch.topk(-d2, min(k + 1, ids.numel()), dim=1)
    return vals, ids[pos]


def against_oracle(tag, scores, ids, want_v, want_i) -> None:
    """Engine scores (-d2, fp32) within the L2 tolerance of the fp64 oracle
    and ids equal outside its near-ties."""
    k = scores.shape[1]
    wv = want_v[:, :k].cpu().numpy()
    err = float(np.abs(scores - wv).max())
    tol = float((L2_ATOL + L2_RTOL * np.abs(wv)).max())
    agree, total = ids_outside_ties(want_v, want_i, torch.from_numpy(ids),
                                    L2_RTOL, L2_ATOL)
    check(err <= tol, f"{tag}: scores differ from the fp64 oracle by {err}")
    check(agree == total, f"{tag}: {total - agree} ids differ from the fp64 "
          "oracle outside near-ties")
    print(f"[{tag}] first batch vs fp64 oracle: max score err {err:.3g}, ids "
          f"{agree}/{total} equal outside near-ties")


def masked_kernels(ix: dict, masks, q_t, power) -> dict:
    """B2 masked (the flat fp32 and bf16 indexes' rows) and masked+scaled
    (the flat int8 index's codes) at kk=18 and 128 under the P2 and P3
    masks, and under the first 10 rows of P3 (dead slots); B5 mask= on the
    IVF fp32, bf16 and int8 slabs at k=18, as the mask plan's exhaustive
    all-lists scan under P2 and P3 and as the routed plan's scan of the
    lists P3 routes to. Each against its plain version on the same CUDA
    tensors."""
    res = {}
    few = torch.zeros_like(masks["P3"])
    few[torch.nonzero(masks["P3"]).flatten()[:10]] = 1.0
    cases = [("P2", masks["P2"]), ("P3", masks["P3"]), ("P3[:10]", few)]
    for suffix in ("", "_bf16", "_int8"):
        name = "score_topk_masked" + suffix
        be = ix["flat" + suffix.replace("_", "-")].backend
        x, sq, sc = be.vectors, be.sq_norms, be.scales
        row_bytes = x.element_size() * D + 4 + (0 if sc is None else 4)
        for pname, mask in cases:
            elig = int(mask.sum())
            for kk in (K_MASK, K_FOLD):
                vals, ids = ops.score_topk(x, sq, q_t, kk, scales=sc,
                                           mask=mask)
                rv, ri = ref.ref_score_topk(x, sq, q_t, kk + 1, sc, mask)
                dead = torch.isneginf(rv[:, :kk])
                check(torch.equal(torch.isneginf(vals), dead)
                      and bool((ids[dead] == 0).all()),
                      f"{name} {pname} kk={kk}: dead slots are not "
                      "(-inf, 0)")
                live = ~dead
                err = (vals - rv[:, :kk])[live].abs().max().item()
                share = tol_share(vals, rv[:, :kk])
                e64, p64 = fp64_errs(x, sq, q_t, vals, ids, sc)
                check(share <= 1.0, f"{name} {pname} kk={kk} error {err}: "
                      f"{share:.3f} of its slot's tolerance")
                # dead slots read -1e30 here, so the near-tie rule sees
                # finite gaps (equal dead slots tie with each other)
                agree, total = ids_outside_ties(
                    torch.where(torch.isneginf(rv), -1e30, rv), ri, ids,
                    L2_RTOL, L2_ATOL)
                check(agree == total, f"{name} {pname} kk={kk}: "
                      f"{total - agree} ids differ outside near-ties")
                ms = time_ms(lambda: ops.score_topk(x, sq, q_t, kk,
                                                    scales=sc, mask=mask))
                plain = time_ms(lambda: ref.ref_score_topk(x, sq, q_t, kk,
                                                           sc, mask), 3)
                pair = pair_ms(x, sq, q_t, kk, sc, mask)
                # the function's work: the eligible rows read once and
                # scored against every query (the kernel gathers them by
                # id), the whole mask read, queries read and (vals, ids)
                # written
                io = 4 * N + q_t.nbytes + 8 * B * kk
                bnd, by, unit = scan_bound_ms(io + elig * row_bytes,
                                              B * elig, D, x.dtype)
                print(f"[kernel] {name} mask {pname} ({elig} eligible "
                      f"rows) b={B} kk={kk}: max_abs_err {err:.3g} "
                      f"({share:.3f} of the tolerance; against fp64 the scan "
                      f"{e64:.3g}, the plain version {p64:.3g}) ids "
                      f"{agree}/{total} outside near-ties, "
                      f"{int(dead.sum())} dead slots (-inf, 0); kernel_ms "
                      f"{ms:.4f} plain_ms {plain:.4f} pair_ms {pair:.4f} "
                      f"bound_ms {bnd:.4f} ({by}, {unit}); "
                      f"card {power}")
                if pname == "P2" and kk == K_MASK:
                    res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                     bound_ms=bnd, bound_by=by,
                                     library_ms=None)
                else:
                    res[name]["max_abs_err"] = max(err,
                                                   res[name]["max_abs_err"])
                del vals, ids, rv, ri
    torch.cuda.empty_cache()

    every = torch.arange(NLIST, dtype=torch.int32, device=q_t.device)
    for suffix in ("", "_bf16", "_int8"):
        name = "ivf_score_topk_dedup_masked" + suffix
        ib = ix["ivf" + suffix.replace("_", "-")].backend
        gsc = ib.grouped_scales
        row_bytes = ib.grouped.element_size() * D + 4 + (
            0 if gsc is None else 4)
        route, n_live = ivf_mod.eligible_lists(ib.lists, masks["P3"] > 0.5)
        scans = [("all", pname, every, NLIST) for pname in ("P2", "P3")]
        scans.append(("routed", "P3", route, n_live))
        for scan, pname, uniq, n_scan in scans:
            # the routed plan's member matrix: 0 on the tail slots, which
            # repeat a live id
            member = (torch.arange(uniq.numel(), device=q_t.device)
                      < n_scan)[:, None].to(torch.float32).expand(
                          uniq.numel(), B).contiguous()
            gmask = ivf_mod.grouped_mask(ib, masks[pname] > 0.5)
            ded = (ib.grouped, ib.grouped_sq, ib.valid, uniq, member, q_t)
            vals, ids = ops.ivf_score_topk_dedup(*ded, K_MASK, scales=gsc,
                                                 mask=gmask)
            rv, ri = ref.ref_ivf_score_topk_dedup(*ded, K_MASK + 1, gsc,
                                                  gmask)
            err = (vals - rv[:, :K_MASK]).abs().max().item()
            share = tol_share(vals, rv[:, :K_MASK])
            agree, total = ids_outside_ties(rv, ri, ids, L2_RTOL, L2_ATOL)
            check(share <= 1.0, f"{name} {scan} {pname} error {err}: "
                  f"{share:.3f} of its slot's tolerance")
            check(agree == total, f"{name} {scan} {pname}: {total - agree} "
                  "ids differ outside near-ties")
            ms = time_ms(lambda: ops.ivf_score_topk_dedup(
                *ded, K_MASK, scales=gsc, mask=gmask), 5)
            plain = time_ms(lambda: ref.ref_ivf_score_topk_dedup(
                *ded, K_MASK, gsc, gmask), 2)
            scanned = torch.zeros(NLIST, dtype=torch.bool,
                                  device=q_t.device)
            scanned[uniq[:n_scan].long()] = True
            live = int(((ib.valid * gmask) > 0.5)[scanned].sum())
            # as for the flat scan: the larger of the bytes (the eligible
            # rows read once, the scanned lists' valid and mask flags, the
            # queries and member matrix, (vals, ids) written) and the
            # function's 2 b n_elig d flops at the tensor cores' peak (TF32
            # for fp32 rows, bf16 otherwise)
            bnd, by, unit = scan_bound_ms(
                live * row_bytes + 8 * n_scan * ib.max_list + q_t.nbytes
                + member.nbytes + 8 * B * K_MASK, B * live, D,
                ib.grouped.dtype)
            sel_ms = time_ms(lambda: ivf_kern.ivf_score_topk_dedup(
                *ded, K_MASK, gsc, gmask, _select=True), 5)
            print(f"[kernel] {name} {scan} ({n_scan} of {NLIST} lists in "
                  f"{uniq.numel()} slots), mask {pname} ({live} eligible "
                  f"rows) b={B} k={K_MASK}: max_abs_err {err:.3g} "
                  f"({share:.3f} of the tolerance) ids {agree}/{total} "
                  f"outside near-ties; kernel_ms {ms:.4f} "
                  f"(selection path forced {sel_ms:.4f}) plain_ms "
                  f"{plain:.4f} bound_ms {bnd:.4f} ({by}, {unit}); card "
                  f"{power}")
            if scan == "all" and pname == "P2":
                res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                 bound_ms=bnd, bound_by=by, library_ms=None)
            else:
                res[name]["max_abs_err"] = max(err, res[name]["max_abs_err"])
            del vals, ids, rv, ri, gmask
        torch.cuda.empty_cache()
    print(f"[3f-kernel] masked variants agree with their plain versions; "
          f"card {power}")
    return res


def serve_predicates(tag, eng, inp: Inputs, power, preds, timed=512):
    """A warm-up batch and ``timed`` queries in batches of 64 per predicate;
    prints qps, p50/p99 and the plan counters. Returns {predicate: (plan,
    kp, p50 ms, first batch (scores, ids))}."""
    out = {}
    for pname in preds:
        pred = PREDICATES[pname]
        cp = compile_predicate(pred, eng._attr_names)
        plan = eng.planner.choose(cp)
        kp = eng.planner.kp_for(plan, cp, eng.cfg.k)
        before = dataclasses.replace(eng.stats)
        eng.search(inp.q_warm, filter=pred)
        lat, runs = [], []
        for s in range(0, timed, B):
            t0 = time.perf_counter()
            runs.append(eng.search(inp.q_all[s:s + B], filter=pred))
            lat.append(time.perf_counter() - t0)
        first = runs[0]
        st = eng.stats
        plans = {p: getattr(st, f"plan_{p}") - getattr(before, f"plan_{p}")
                 for p in ("fold", "mask", "routed")}
        fb = st.filtered_fallbacks - before.filtered_fallbacks
        p50 = 1e3 * float(np.percentile(lat, 50))
        print(f"[{tag}] {pname} plan {plan} kp {kp} (planner sel "
              f"{eng.planner.selectivity(cp):.4f}): {timed} queries in "
              f"batches of {B}: qps {timed / sum(lat):.1f} batch p50 "
              f"{p50:.2f} ms p99 {1e3 * np.percentile(lat, 99):.2f} ms; "
              f"plans {plans}, fold fallbacks {fb}; card {power}")
        check(np.isfinite(first[0]).all() and (first[1] >= 0).all(),
              f"{tag} {pname}: the first batch has dead or non-finite slots")
        out[pname] = (plan, kp, p50, first)
    return out


def predicate_checks(tag, eng, inp: Inputs, served, state0) -> None:
    """The first batch of each predicate against the fp64 oracle on the
    card, then against a CPU engine on the same state and attributes."""
    rows = dequantized(eng.index.backend)
    q = inp.q_all[:B]
    for pname, (plan, kp, _, (scores, ids)) in served.items():
        pred = PREDICATES[pname]
        wv, wi = filtered_oracle(rows, eligibility(eng, pred),
                                 folded(eng, pred, q), eng.cfg.k)
        against_oracle(f"{tag} {pname}", scores, ids, wv, wi)
    del rows
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu_ix = fcvi.index_from_state(eng.index.config, state0, device="cpu")
    cpu_eng = engine_mod.FCVIEngine(cpu_ix, engine_mod.EngineConfig(),
                                    device="cpu",
                                    attributes=inp.corpus.filters)
    for pname, (plan, kp, _, (scores, ids)) in served.items():
        cs, ci = cpu_eng.search(q, filter=PREDICATES[pname])
        err = float(np.abs(scores - cs).max())
        tol = float((L2_ATOL + L2_RTOL * np.abs(cs)).max())
        # the CPU engine's 11th score is unknown: its last slot counts as a
        # near-tie, as in ``same_top10``
        nxt = np.concatenate([cs, cs[:, -1:]], axis=1)
        agree, total = ids_outside_ties(torch.from_numpy(nxt),
                                        torch.from_numpy(ci),
                                        torch.from_numpy(ids), L2_RTOL,
                                        L2_ATOL)
        check(err <= tol and agree == total, f"{tag} {pname}: first batch "
              f"differs from the CPU engine (err {err}, ids {agree}/{total})")
        same = int((cs == scores).all(axis=1).sum())
        print(f"[{tag}] {pname} first batch vs CPU engine ({plan}): max "
              f"score err {err:.3g}, ids {agree}/{total} outside near-ties, "
              f"{same} of {B} rows bit-equal")
    print(f"[{tag}] CPU engine checks {time.perf_counter() - t0:.1f} s")


def phase_predicates(dev, power: str, inp: Inputs, ix: dict):
    """Phase 3f: predicate search at n=1M over the indexes the earlier
    phases built (``ix``: flat, flat-bf16, flat-int8, ivf, ivf-bf16,
    ivf-int8): flat fp32, flat int8 and IVF fp32 serve 512 timed queries
    per predicate, flat bf16, IVF bf16 and IVF int8 a warm-up and one batch
    each; the masked kernels against their plain versions; forced plans bit
    for bit; P4 certified empty; the delta tier. Returns the masked
    kernels' results and the serving runs' launch counts (the kernel checks
    are not counted)."""
    attrs = inp.corpus.filters
    counts, res, p50s = {}, {}, {}

    def add(run):
        for name, n in run.items():
            counts[name] = counts.get(name, 0) + n

    def engine(tag):
        return engine_mod.FCVIEngine(ix[tag], engine_mod.EngineConfig(),
                                     device=dev, attributes=attrs)

    flat_eng, ivf_eng = engine("flat"), engine("ivf")
    masks, sel = {}, {}
    for pname, pred in PREDICATES.items():
        elig = eligibility(flat_eng, pred)
        masks[pname] = elig.to(torch.float32)
        sel[pname] = float(elig.double().mean())
    print(f"[3f] true selectivity on the corpus: "
          + ", ".join(f"{p} {v:.4f}" for p, v in sel.items()))
    q_t = folded(flat_eng, PREDICATES["P2"], inp.q_all[:B]).contiguous()
    res.update(masked_kernels(ix, masks, q_t, power))

    for tag, eng in (("flat", flat_eng), ("flat-int8", engine("flat-int8")),
                     ("ivf", ivf_eng)):
        state0 = fcvi.index_state(eng.index)
        _build.reset_launch_counts()
        served = serve_predicates(tag, eng, inp, power, PREDICATES)
        torch.cuda.synchronize()
        run = _build.launch_counts()
        add(run)
        print(f"[{tag}] 3f counts {json.dumps(run)}")
        for pname, (plan, _, p50, _) in served.items():
            p50s[f"{tag} {pname} {plan}"] = round(p50, 2)
        predicate_checks(tag, eng, inp, served, state0)
        del state0
        torch.cuda.empty_cache()

    # forced plans, bit for bit, on the first batch
    qb = inp.q_all[:B]
    for tag, eng, pname, plans in (("flat", flat_eng, "P1", ("fold", "mask")),
                                   ("ivf", ivf_eng, "P3",
                                    ("routed", "mask"))):
        _build.reset_launch_counts()
        (s0, i0), (s1, i1) = (eng.search(qb, filter=PREDICATES[pname],
                                         plan=p) for p in plans)
        add(_build.launch_counts())
        check(np.array_equal(s0, s1) and np.array_equal(i0, i1),
              f"{tag} {pname}: plan={plans[0]} and plan={plans[1]} differ")
        print(f"[{tag}] {pname}: plan={plans[0]} and plan={plans[1]} equal "
              f"bit for bit over {B} queries")
    route = ivf_mod.eligible_lists(ivf_eng.index.backend.lists,
                                   masks["P3"] > 0.5)
    print(f"[ivf] P3 routes to {route[1]} of {NLIST} lists "
          f"({route[0].numel()} slots)")

    # P4 matches nothing: certified empty
    _build.reset_launch_counts()
    s, i = flat_eng.search(qb, filter=P4)
    check((i == -1).all() and np.isneginf(s).all(),
          "P4: a zero-match predicate did not return (-inf, -1)")
    check(not _build.launch_counts(), "P4: a zero-match predicate launched "
          "a kernel")
    print("[flat] P4 (no row matches): every slot (-inf, -1), no launch")

    # the delta tier: 1,000 inserts, P2 against the oracle over both tiers
    _build.reset_launch_counts()
    flat_eng.insert(inp.new_v, inp.new_f)
    s, i = flat_eng.search(qb, filter=PREDICATES["P2"])
    add(_build.launch_counts())
    delta = flat_eng._ensure_delta()
    rows = torch.cat([dequantized(flat_eng.index.backend),
                      dequantized(delta.flat)])
    elig = torch.cat([eligibility(flat_eng, PREDICATES["P2"]),
                      eval_mask(torch.tensor(inp.new_f, device=dev),
                                *compile_predicate(
                                    PREDICATES["P2"],
                                    flat_eng._attr_names).as_arrays(dev))])
    wv, wi = filtered_oracle(rows, elig, folded(flat_eng, PREDICATES["P2"],
                                                qb), 10)
    against_oracle("flat P2 + 1,000 inserts", s, i, wv, wi)
    print(f"[flat] P2 after 1,000 inserts: {int((i >= N).sum())} result "
          f"slots are delta rows ({int(elig[N:].sum())} eligible inserts)")
    del rows, delta
    torch.cuda.empty_cache()

    # the bf16 flat rung and the IVF bf16 and int8 slabs serve one batch
    # each
    for tag in ("flat-bf16", "ivf-bf16", "ivf-int8"):
        eng = engine(tag)
        _build.reset_launch_counts()
        served = serve_predicates(tag, eng, inp, power, ("P2", "P3"), B)
        run = _build.launch_counts()
        add(run)
        print(f"[{tag}] 3f counts {json.dumps(run)}")
        rows = dequantized(eng.index.backend)
        for pname, (_, _, _, (scores, ids)) in served.items():
            pred = PREDICATES[pname]
            wv, wi = filtered_oracle(rows, eligibility(eng, pred),
                                     folded(eng, pred, qb), 10)
            against_oracle(f"{tag} {pname}", scores, ids, wv, wi)
        del eng, rows
        torch.cuda.empty_cache()
    print(f"[3f] batch p50 ms by index, predicate and plan: "
          f"{json.dumps(p50s)}; card {power}")
    print(f"[3f] counts {json.dumps(counts)}")
    return res, counts


# -- phase 3g: shapes the reference serves ----------------------------------

EMB_D, GIST_D = 384, 960     # a sentence-embedding width; GIST1M's width
KK_WIDE = 2056               # EngineConfig(k=64)'s escalated flat width


def counted(tag: str, counts: dict, fn):
    """Run ``fn`` with the launch counters at 0, fail unless a kernel
    counter moved, add the counts to ``counts``; returns fn's result."""
    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    run = _build.launch_counts()
    check(bool(run), f"{tag}: no kernel was launched")
    for name, n in run.items():
        counts[name] = counts.get(name, 0) + n
    print(f"[3g] {tag}: counts {json.dumps(run)}")
    return out


def wide_kernels(tag, x, sq, pv, pf, mask, q_t, power) -> None:
    """B2, B3 and B2 masked on (n, d) rows at kk=88, 328 and 2056 against
    their plain versions (the L2 tolerance plus ``depth_atol``), B3
    bit-equal to B2; each timed beside its bound, its plain version and the
    library pair."""
    n, d = x.shape
    n_elig = int((mask > 0.5).sum())
    atol = L2_ATOL + depth_atol(q_t, x, d)               # (b, 1)
    atol_np = atol.cpu().numpy()
    scan_in = 4 * (n * d + n + B * d)
    for kk in (KP + 8, 4 * KP + 8, KK_WIDE):
        p = scan_mod.plan(n, B, kk, d, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
        vals, ids = ops.score_topk(x, sq, q_t, kk)
        rvals, rids = ref.ref_score_topk(x, sq, q_t, kk + 1)
        err = (vals - rvals[:, :kk]).abs().max().item()
        share = tol_share(vals, rvals[:, :kk], atol)
        ok = ((vals - rvals[:, :kk]).abs()
              <= atol + L2_RTOL * rvals[:, :kk].abs()).all().item()
        agree, total = ids_outside_ties(rvals, rids, ids, L2_RTOL, atol_np)
        check(ok and agree == total, f"{tag} score_topk kk={kk}: error "
              f"{err}, ids {agree}/{total}")
        out = ops.score_topk_rows(x, sq, pv, pf, q_t, kk)
        idx = ids.long()
        check(torch.equal(out[0], vals) and torch.equal(out[1], ids)
              and torch.equal(out[2], x[idx]) and torch.equal(out[3], pv[idx])
              and torch.equal(out[4], pf[idx]),
              f"{tag} score_topk_rows kk={kk} differs from B2 + gather")
        del out, rvals, rids
        mv, mi = ops.score_topk(x, sq, q_t, kk, mask=mask)
        rv, ri = ref.ref_score_topk(x, sq, q_t, kk + 1, mask=mask)
        live = ~torch.isneginf(rv[:, :kk])
        check(torch.equal(torch.isneginf(mv), ~live),
              f"{tag} masked kk={kk}: dead slots differ")
        merr = (mv - rv[:, :kk])[live].abs().max().item()
        share = max(share, tol_share(mv, rv[:, :kk], atol))
        mok = ((mv - rv[:, :kk]).abs()
               <= atol + L2_RTOL * rv[:, :kk].abs())[live].all().item()
        rvf = torch.where(torch.isneginf(rv), -1e30, rv)
        magree, mtotal = ids_outside_ties(rvf, ri, mi, L2_RTOL, atol_np)
        check(mok and magree == mtotal, f"{tag} masked kk={kk}: error "
              f"{merr}, ids {magree}/{mtotal}")
        del mv, mi, rv, ri, rvf
        rows_bytes = 4 * B * kk * (2 * pv.shape[1] + 2 * pf.shape[1] + d)
        pair = pair_ms(x, sq, q_t, kk, iters=2)
        t = {"score_topk": (
                lambda: ops.score_topk(x, sq, q_t, kk),
                lambda: ref.ref_score_topk(x, sq, q_t, kk), pair,
                scan_bound_ms(scan_in + 8 * B * kk, B * n, d, x.dtype)),
             "score_topk_rows": (
                lambda: ops.score_topk_rows(x, sq, pv, pf, q_t, kk),
                lambda: ref.ref_score_topk_rows(x, sq, pv, pf, q_t, kk),
                pair, scan_bound_ms(scan_in + 8 * B * kk + rows_bytes,
                                    B * n, d, x.dtype)),
             "score_topk_masked": (
                lambda: ops.score_topk(x, sq, q_t, kk, mask=mask),
                lambda: ref.ref_score_topk(x, sq, q_t, kk, mask=mask),
                pair_ms(x, sq, q_t, kk, mask=mask, iters=2),
                scan_bound_ms(4 * (n_elig * (d + 1) + n + B * d)
                              + 8 * B * kk, B * n_elig, d, x.dtype))}
        for name, (kern, plain_fn, pms, (bnd, by, unit)) in t.items():
            ms = time_ms(kern, 5)
            plain = time_ms(plain_fn, 2)
            print(f"[kernel] {name} ({tag}) b={B} n={n} d={d} kk={kk} "
                  f"(bq {p.bq}, {'selection' if p.select else 'buffered'} "
                  f"path): max_abs_err {max(err, merr):.3g} ({share:.3f} of "
                  f"the tolerance; depth term of "
                  f"the tolerance up to {atol_np.max():.3g}); kernel_ms "
                  f"{ms:.4f} plain_ms {plain:.4f} pair_ms {pms:.4f} "
                  f"bound_ms {bnd:.4f} ({by}, {unit}); card "
                  f"{power}")
        torch.cuda.empty_cache()
    print(f"[3g] {tag}: B2, B3, B2 masked agree with their plain versions at "
          f"d={d}, kk {KP + 8}, {4 * KP + 8} and {KK_WIDE} ({n_elig} "
          f"eligible rows)")


def select_kernels(flat_ix, ivf_ix, inp: Inputs, dev, power) -> dict:
    """The selection path forced, bit-equal to the buffered path: flat B2
    and B3 at kk = 88, 328 and 1032 on phase 3's rows, and at kk = 2048 and
    2056 (past the buffers) against the plain version; IVF B5, B6 and B7
    at k = 80 and 3200 on phase 3b's slabs; each timed beside the buffered
    path, its plain version and the bound. Returns the kernels-line entries
    of the selection counters (flat at kk=2056, IVF at k=3200)."""
    res = {}
    qv, qf = (torch.tensor(a, device=dev) for a in (inp.q_all[:B],
                                                    inp.f_all[:B]))
    be = flat_ix.backend
    x, sq = be.vectors, be.sq_norms
    pv, pf = flat_ix.vectors_n, flat_ix.filters_n
    q_t = flat_ix.transform.apply(qv, qf).contiguous()
    scan_in = 4 * (N * D + N + B * D)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kk in (KP + 8, 4 * KP + 8, 1032, 2048, KK_WIDE):
        try:
            scan_mod.plan(N, B, kk, D, sms, select=False)
            buffered = True
        except ValueError:   # past the buffers: the selection path only
            buffered = False
        pair = pair_ms(x, sq, q_t, kk, iters=2)
        runs = {"score_topk": (
                    lambda s: scan_mod.score_topk(x, sq, q_t, kk, _select=s),
                    lambda: ref.ref_score_topk(x, sq, q_t, kk),
                    scan_bound_ms(scan_in + 8 * B * kk, B * N, D, x.dtype)),
                "score_topk_rows": (
                    lambda s: scan_mod.score_topk_rows(x, sq, pv, pf, q_t,
                                                       kk, _select=s),
                    lambda: ref.ref_score_topk_rows(x, sq, pv, pf, q_t, kk),
                    scan_bound_ms(scan_in + 8 * B * kk
                                  + 4 * B * kk * (2 * (D + M) + D), B * N, D,
                                  x.dtype))}
        for name, (kern, plain_fn, (bnd, by, unit)) in runs.items():
            a = kern(True)
            if buffered:
                check(all(torch.equal(u, v) for u, v in zip(a, kern(False))),
                      f"{name} kk={kk}: selection path differs from "
                      "buffered")
            rv, ri = ref.ref_score_topk(x, sq, q_t, kk + 1)
            err = (a[0] - rv[:, :kk]).abs().max().item()
            share = tol_share(a[0], rv[:, :kk])
            agree, total = ids_outside_ties(rv, ri, a[1], L2_RTOL, L2_ATOL)
            check(share <= 1.0 and agree == total, f"{name}_select kk={kk} "
                  f"error {err} ({share:.3f} of its slot's tolerance), ids "
                  f"{agree}/{total}")
            del a, rv, ri
            ms_sel = time_ms(lambda: kern(True), 5)
            ms_buf = time_ms(lambda: kern(False), 5) if buffered else None
            plain = time_ms(plain_fn, 2)
            versus = (f"bit-equal to the buffered path (buffered "
                      f"{ms_buf:.4f} ms)" if buffered else
                      "past the buffers: against the plain version")
            print(f"[kernel] {name}_select (forced) b={B} n={N} d={D} "
                  f"kk={kk}: {versus}; max_abs_err {err:.3g} ({share:.3f} "
                  f"of the tolerance); kernel_ms "
                  f"{ms_sel:.4f} plain_ms {plain:.4f} pair_ms {pair:.4f} "
                  f"bound_ms {bnd:.4f} ({by}, {unit}); card "
                  f"{power}")
            if kk == KK_WIDE:
                res[name + "_select"] = dict(
                    max_abs_err=err, ms=ms_sel, plain_ms=plain, bound_ms=bnd,
                    bound_by=by, library_ms=None)
        torch.cuda.empty_cache()

    ib = ivf_ix.backend
    q_t = ivf_ix.transform.apply(qv, qf).contiguous()
    c2 = torch.sum(ib.centroids * ib.centroids, dim=-1)
    _, probes = ops.score_topk(ib.centroids, c2, q_t, NPROBE)
    uniq, member = ops.dedup_probes(probes, NLIST)
    gpv = ivf_mod.build_grouped_payload(ivf_ix.vectors_n, ib.lists)
    gpf = ivf_mod.build_grouped_payload(ivf_ix.filters_n, ib.lists)
    grp = (ib.grouped, ib.grouped_sq, ib.valid)
    ded = (*grp, uniq, member, q_t)
    for k in (KP, 40 * KP):
        runs = {"ivf_score_topk_dedup": (
                    lambda s: ivf_kern.ivf_score_topk_dedup(*ded, k,
                                                            _select=s),
                    lambda: ref.ref_ivf_score_topk_dedup(*ded, k), 0),
                "ivf_score_topk_dedup_rows": (
                    lambda s: ivf_kern.ivf_score_topk_dedup_rows(
                        *ded, gpv, gpf, k, _select=s),
                    lambda: ref.ref_ivf_score_topk_dedup_rows(*ded, gpv, gpf,
                                                              k), D + M),
                "ivf_score_topk_batch": (
                    lambda s: ivf_kern.ivf_score_topk_batch(
                        *grp, probes, q_t, k, _select=s),
                    lambda: ref.ref_ivf_score_topk_batch(*grp, probes, q_t,
                                                         k), 0)}
        buffered = not ivf_kern.plan(k, D, ib.grouped.dtype).select
        for name, (kern, plain_fn, row_floats) in runs.items():
            a = kern(True)
            if buffered:
                check(all(torch.equal(u, v) for u, v in zip(a, kern(False))),
                      f"{name} k={k}: selection path differs from buffered")
            want = plain_fn()[0]
            live = ~torch.isneginf(want)
            check(torch.equal(torch.isneginf(a[0]), ~live),
                  f"{name}_select k={k}: dead slots differ from plain")
            err = (a[0] - want)[live].abs().max().item()
            share = tol_share(a[0], want)
            check(share <= 1.0, f"{name}_select k={k} error {err}: "
                  f"{share:.3f} of its slot's tolerance")
            del a, want
            ms_sel = time_ms(lambda: kern(True), 5)
            plain = time_ms(plain_fn, 2)
            bnd, by, _, _ = ivf_bound(ib, uniq, member, B, k, row_floats)
            versus = (f"bit-equal to the buffered path (buffered "
                      f"{time_ms(lambda: kern(False), 5):.4f} ms)"
                      if buffered else
                      "past the buffers: against the plain version")
            print(f"[kernel] {name}_select (forced) b={B} nlist={NLIST} "
                  f"nprobe={NPROBE} k={k}: {versus}; max_abs_err {err:.3g} "
                  f"({share:.3f} of the tolerance); "
                  f"kernel_ms {ms_sel:.4f} plain_ms {plain:.4f} bound_ms "
                  f"{bnd:.4f} ({by}); card {power}")
            if k == 40 * KP:
                res[name + "_select"] = dict(
                    max_abs_err=err, ms=ms_sel, plain_ms=plain, bound_ms=bnd,
                    bound_by=by, library_ms=None)
        torch.cuda.empty_cache()
    return res


def select_alone(flat_ix, inp: Inputs, dev, power) -> dict:
    """The selection path's select on its own (``topk_select.select_topk``,
    the kernels every *_select launch runs) over the (64, 1M) fp32 scores of
    phase 3's rows and first batch, at kk = 88 and 2056, bit-equal to its
    plain version; timed beside ``torch.topk(scores, kk, dim=1,
    sorted=True)`` on the same scratch (its one-call library counterpart)
    and its bytes bound (each query's live entries read once, (vals, ids)
    written), with each launch's span from the select's own profile. Then
    every score equal on a (4, 1M) scratch: the full-row passes under the
    prefix, bit-equal too. Returns the kernels-line entry (kk=2056)."""
    res = {}
    qv, qf = (torch.tensor(a, device=dev) for a in (inp.q_all[:B],
                                                    inp.f_all[:B]))
    be = flat_ix.backend
    q_t = flat_ix.transform.apply(qv, qf).contiguous()
    scores = (2.0 * (q_t @ be.vectors.T) - be.sq_norms[None, :]) \
        - torch.sum(q_t * q_t, dim=-1, keepdim=True)
    ties = torch.full((4, N), -1.25, device=dev)
    for tag, s, kks in (("flat scores", scores, (KP + 8, KK_WIDE)),
                        ("every score equal", ties, (KP + 8,))):
        for kk in kks:
            stats = _build.select_stats(dev)
            got = topk_select.select_topk(s, kk, _stats=stats)
            want = ref.ref_select_topk(s, kk)
            check(torch.equal(got[0].view(torch.int32),
                              want[0].view(torch.int32))
                  and torch.equal(got[1], want[1]),
                  f"select {tag} kk={kk} differs from its plain version")
            st = stats.tolist()
            spans = [(st[3 * p + 1] - st[3 * p]) / 1e6 if st[3 * p + 2]
                     else 0.0 for p in range(_build.SELECT_PASSES + 1)]
            modes = ["".join(m for bit, m in ((1, "h"), (2, "c"))
                             if st[3 * p + 2] & bit) or "-"
                     for p in range(_build.SELECT_PASSES)]
            hists = sum(st[3 * p + 2] & 1 for p in range(_build.SELECT_PASSES))
            if tag == "every score equal":
                check(hists == 4, f"select {tag}: {hists} histogram passes, "
                      "not the four full-row passes")
            ms = time_ms(lambda: topk_select.select_topk(s, kk))
            lib = time_ms(lambda: torch.topk(s, kk, dim=1, sorted=True))
            plain = time_ms(lambda: ref.ref_select_topk(s, kk), 2)
            live = int(torch.isfinite(s).sum())
            bnd, by = bound_ms(4 * live + 8 * s.shape[0] * kk, 0)
            print(f"[kernel] select ({tag}) b={s.shape[0]} n={N} kk={kk}: "
                  f"bit-equal to its plain version; launches (h histogram, "
                  f"c compaction) {modes}, spans ms "
                  f"{[round(t, 4) for t in spans]} (the last: the finish); "
                  f"kernel_ms {ms:.4f} plain_ms {plain:.4f} torch.topk "
                  f"{lib:.4f} bound_ms {bnd:.4f} ({by}); card {power}")
            if tag == "flat scores" and kk == KK_WIDE:
                res["select"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                     bound_ms=bnd, bound_by=by,
                                     library_ms=lib)
    del scores, ties
    torch.cuda.empty_cache()
    return res


def serve_wide(tag, eng, q, f, timed, power):
    """A warm-up batch, then ``timed`` queries in batches of 64: prints
    qps, p50/p99 and escalations; returns the first batch (scores, ids)."""
    eng.search(q[-B:], f[-B:])
    esc0 = eng.stats.escalations
    lat, first = [], None
    for s in range(0, timed, B):
        t0 = time.perf_counter()
        out = eng.search(q[s:s + B], f[s:s + B])
        lat.append(time.perf_counter() - t0)
        first = first or out
    k = eng.cfg.k
    check(first[0].shape == (B, k) and np.isfinite(first[0]).all()
          and (first[1] >= 0).all(), f"{tag}: first batch malformed")
    print(f"[{tag}] {timed} queries in batches of {B} at k={k}: qps "
          f"{timed / sum(lat):.1f} batch p50 "
          f"{1e3 * np.percentile(lat, 50):.2f} ms p99 "
          f"{1e3 * np.percentile(lat, 99):.2f} ms; escalations "
          f"{eng.stats.escalations - esc0} of {timed}; card {power}")
    return first


def phase_shapes(dev, power: str, inp: Inputs, flat_ix, ivf_ix, pq_ix):
    """Phase 3g: shapes the reference serves, through the kernels only.
    Returns the selection counters' kernels-line entries and the launch
    counts of the serving steps (every step must move a counter)."""
    counts, res = {}, {}
    k64 = engine_mod.EngineConfig(k=64)
    qb, fb = inp.q_all[:B], inp.f_all[:B]

    # flat fp32 at EngineConfig(k=64): k' 520, escalated 2056
    eng = engine_mod.FCVIEngine(flat_ix, k64, device=dev)
    s, i = counted("flat k=64, 512 queries", counts, lambda: serve_wide(
        "3g flat k=64", eng, inp.q_all, inp.f_all, 512, power))
    cpu_flat = fcvi.index_from_state(flat_ix.config,
                                     fcvi.index_state(flat_ix), device="cpu")
    against_cpu_engine("3g flat k=64", flat_ix, None, s, i, qb, fb,
                       np.zeros(B, bool), k64, cpu_flat)

    # IVF fp32 at EngineConfig(k=100): k' 800, escalated 3200 (here and
    # below, escalate_margin 10 escalates every query of a one-batch step,
    # so the escalated width is certain to run)
    k100 = engine_mod.EngineConfig(k=100, escalate_margin=10.0)
    eng = engine_mod.FCVIEngine(ivf_ix, k100, device=dev)
    s, i = counted("ivf k=100, one batch", counts, lambda: eng.search(qb, fb))
    check(eng.stats.escalations == B, "3g ivf k=100: not every query "
          "escalated to k'=3200")
    qv, qf = (torch.tensor(a, device=dev) for a in (qb, fb))
    ties = probe_ties(ivf_ix.backend.centroids,
                      ivf_ix.transform.apply(qv, qf), NPROBE)
    print(f"[3g ivf k=100] {eng.stats.escalations} of {B} queries escalated "
          f"to k'=3200; {int(ties.sum())} at a probe near-tie")
    against_cpu_engine("3g ivf k=100", ivf_ix, fcvi.index_state(ivf_ix), s,
                       i, qb, fb, ties, k100)

    # past the buffers: the selection path through the serving entry points
    k128 = engine_mod.EngineConfig(k=128, escalate_margin=10.0)
    eng = engine_mod.FCVIEngine(flat_ix, k128, device=dev)
    s, i = counted("flat k=128 (escalated kk=4104), one batch", counts,
                   lambda: eng.search(qb, fb))
    check(eng.stats.escalations > 0, "3g flat k=128: no escalation")
    against_cpu_engine("3g flat k=128", flat_ix, None, s, i, qb, fb,
                       np.zeros(B, bool), k128, cpu_flat)
    del cpu_flat
    eng = engine_mod.FCVIEngine(ivf_ix, k128, device=dev)
    counted("ivf k=128 (escalated k'=4096), one batch; fcvi.query and B7 "
            "at k'=4096", counts, lambda: (
                eng.search(qb, fb),
                fcvi.query(ivf_ix, qv, qf, 10, k_prime=4096),
                ops.ivf_score_topk_batch(
                    ivf_ix.backend.grouped, ivf_ix.backend.grouped_sq,
                    ivf_ix.backend.valid,
                    ops.score_topk(ivf_ix.backend.centroids, torch.sum(
                        ivf_ix.backend.centroids ** 2, dim=-1),
                        ivf_ix.transform.apply(qv, qf).contiguous(),
                        NPROBE)[1],
                    ivf_ix.transform.apply(qv, qf).contiguous(), 4096)))
    check(eng.stats.escalations > 0, "3g ivf k=128: no escalation")
    eng = engine_mod.FCVIEngine(pq_ix, engine_mod.EngineConfig(
        k=512, escalate_margin=10.0), device=dev)
    s, i = counted("pq k=512 (escalated k'=16384), one batch", counts,
                   lambda: eng.search(qb, fb))
    check(np.isfinite(s).all() and ((i >= 0) & (i < N)).all()
          and eng.stats.escalations > 0, "3g pq k=512: malformed or no "
          "escalation")
    del eng
    torch.cuda.empty_cache()

    # a forced fold at P3's selectivity: kp=4096, past the buffers, equal
    # to plan="mask" (the fold plan takes one attribute, so P3's band alone)
    eng = engine_mod.FCVIEngine(flat_ix, engine_mod.EngineConfig(),
                                device=dev, attributes=inp.corpus.filters)
    kp = eng.planner.kp_for("fold", compile_predicate(P3_FOLD,
                                                      eng._attr_names), 10)
    (s0, i0), (s1, i1) = counted(
        f"flat P3-band plan=fold (kp={kp}) and plan=mask", counts,
        lambda: [eng.search(qb, filter=P3_FOLD, plan=p)
                 for p in ("fold", "mask")])
    check(kp >= min(4096, N) and np.array_equal(s0, s1)
          and np.array_equal(i0, i1),
          f"3g P3-band: plan=fold (kp={kp}) differs from plan=mask")
    print(f"[3g] P3-band plan=fold at kp={kp} equals plan=mask bit for bit "
          f"over {B} queries")
    del eng
    res.update(select_kernels(flat_ix, ivf_ix, inp, dev, power))
    res.update(select_alone(flat_ix, inp, dev, power))

    # a GIST1M-shaped flat corpus: n=1M rows of d=960
    t0 = time.perf_counter()
    gist = make_corpus(CorpusSpec(n=N, d=GIST_D, n_categories=6,
                                  n_numeric=2, seed=0))
    gq, gf = sample_queries(gist, B, seed=1)
    print(f"[3g] GIST1M-shaped corpus n={N} d={GIST_D} m={M}: "
          f"{time.perf_counter() - t0:.1f} s (host, setup)")
    t0 = time.perf_counter()
    gix = counted("gist build", counts, lambda: fcvi.build(
        gist.vectors, gist.filters, fcvi.FCVIConfig(), device=dev))
    print(f"[3g] gist build on the card {time.perf_counter() - t0:.2f} s")
    cpu_gist = fcvi.index_from_state(gix.config, fcvi.index_state(gix),
                                     device="cpu")
    for cfg in (engine_mod.EngineConfig(),
                engine_mod.EngineConfig(k=64, escalate_margin=10.0)):
        eng = engine_mod.FCVIEngine(gix, cfg, device=dev)
        s, i = counted(f"gist k={cfg.k}, one batch", counts,
                       lambda: eng.search(gq, gf))
        against_cpu_engine(f"3g gist k={cfg.k}", gix, None, s, i, gq, gf,
                           np.zeros(B, bool), cfg, cpu_gist)
    del cpu_gist, eng
    gqt = gix.transform.apply(*(torch.tensor(a, device=dev)
                                for a in (gq, gf))).contiguous()
    attrs = torch.tensor(gist.filters, device=dev)
    gmask = eval_mask(attrs, *compile_predicate(
        PREDICATES["P2"], [f"f{j}" for j in range(M)]).as_arrays(dev)).float()
    wide_kernels("gist", gix.backend.vectors, gix.backend.sq_norms,
                 gix.vectors_n, gix.filters_n, gmask, gqt, power)
    del gix, gist, attrs, gmask, gqt
    torch.cuda.empty_cache()

    # an IVF corpus at d=384 (nlist=1024, nprobe=16)
    t0 = time.perf_counter()
    emb = make_corpus(CorpusSpec(n=N, d=EMB_D, n_categories=6, n_numeric=2,
                                 seed=0))
    eq, ef = sample_queries(emb, B, seed=1)
    print(f"[3g] corpus n={N} d={EMB_D}: {time.perf_counter() - t0:.1f} s "
          "(host, setup)")
    t0 = time.perf_counter()
    cfg = fcvi.FCVIConfig(backend="ivf", nlist=NLIST, nprobe=NPROBE)
    eix = counted("ivf d=384 build", counts, lambda: fcvi.build(
        emb.vectors, emb.filters, cfg, device=dev))
    print(f"[3g] ivf d={EMB_D} build on the card "
          f"{time.perf_counter() - t0:.2f} s; max_list "
          f"{eix.backend.max_list}")
    eng = engine_mod.FCVIEngine(eix, engine_mod.EngineConfig(), device=dev)
    s, i = counted("ivf d=384, one batch", counts,
                   lambda: eng.search(eq, ef))
    ev, evf = (torch.tensor(a, device=dev) for a in (eq, ef))
    ties = probe_ties(eix.backend.centroids, eix.transform.apply(ev, evf),
                      NPROBE)
    against_cpu_engine(f"3g ivf d={EMB_D}", eix, fcvi.index_state(eix), s, i,
                       eq, ef, ties)
    del eng
    ivf_kernels(eix, eq, ef, dev, power, ks=(KP, 40 * KP), depth=True)
    eqt = eix.transform.apply(ev, evf).contiguous()
    flat = flat_mod.build(eix.backend.vectors)
    attrs = torch.tensor(emb.filters, device=dev)
    emask = eval_mask(attrs, *compile_predicate(
        PREDICATES["P2"], [f"f{j}" for j in range(M)]).as_arrays(dev)).float()
    wide_kernels(f"d={EMB_D}", flat.vectors, flat.sq_norms, eix.vectors_n,
                 eix.filters_n, emask, eqt, power)
    del eix, emb, flat, attrs, emask
    torch.cuda.empty_cache()
    print(f"[3g] counts {json.dumps(counts)}")
    return res, counts


PRICE = ("f7", 0.3, 0.7)     # phase 3h's price range: 40% of the corpus
R_PROBES = 4                 # EngineConfig().multi_probe_r


def price_box(dev) -> BoxPredicate:
    """``PRICE`` as a BoxPredicate over the m=8 raw filter columns."""
    low = torch.full((M,), -float("inf"), device=dev)
    high = torch.full((M,), float("inf"), device=dev)
    col = int(PRICE[0][1:])
    low[col], high[col] = PRICE[1], PRICE[2]
    return BoxPredicate(low=low, high=high)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, names in os.walk(path) for name in names)


def round_trip(tag: str, eng, tmp: str, inp: Inputs, dev, power: str):
    """Save ``eng`` (1,000 pending inserts) to ``tmp``, restore it on the
    card, and check that the restored engine's first batch is the saved
    engine's, bit for bit. Returns the restored engine."""
    q, f = inp.q_all[:B], inp.f_all[:B]
    eng.insert(inp.new_v, inp.new_f)
    want = eng.search(q, f)
    t0 = time.perf_counter()
    eng.save(tmp)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = engine_mod.FCVIEngine.restore(tmp, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = again.search(q, f)
    check(again.delta_size() == 1000 and again.stats.inserts == 1000,
          f"{tag}: the restored engine lost its pending rows")
    check(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]),
          f"{tag}: the restored engine's first batch differs from the "
          "saved engine's")
    check((want[1] >= N).any(), f"{tag}: no pending row answered")
    print(f"[{tag}] checkpoint {dir_bytes(tmp) / 1e9:.3f} GB written in "
          f"{save_s:.2f} s, restored on the card in {restore_s:.2f} s; the "
          f"restored first batch equals the saved engine's bit for bit "
          f"(1,000 pending rows carried); card {power}")
    return again


def probe_tiles(index, q, probes):
    """The candidate tiles ``fcvi.multi_probe_query`` re-ranks: (vectors
    (b, r k', d), filters (b, r k', m), qn, the normalized probes)."""
    b, r = probes.shape[:2]
    cfg = index.config
    kp = theory.k_prime(10, cfg.lam, cfg.resolved_alpha(), index.size, cfg.c)
    tfm = index.transform
    qn, fqn = tfm.vec_norm.apply(q), tfm.filt_norm.apply(probes)
    q_t = tfm.apply_normalized(qn[:, None].expand(b, r, D), fqn)
    _, cand = fcvi._backend_search(index, q_t.reshape(b * r, -1), kp)
    rows = torch.sort(cand.reshape(b, -1), dim=-1).values.long()
    return (index.vectors_n[rows], index.filters_n[rows], qn,
            [fqn[:, j].contiguous() for j in range(r)])


def probe_rescore(index, q, probes, power: str) -> None:
    """B4 as multi-probe calls it (d = m = 8 at lam = 0, the vectors at
    lam = 1) against its plain version in every slot, timed beside it."""
    cv, cf, qn, probe = probe_tiles(index, q, probes)
    b, c, m = cf.shape
    err = 0.0
    for args, lam in [((cv, cf, qn, probe[0]), 1.0)] + [
            ((cf, cf, p, p), 0.0) for p in probe]:
        err = max(err, (ops.rescore(*args, lam)
                        - ref.ref_rescore(*args, lam)).abs().max().item())
    check(err <= COS_ATOL, f"rescore at d=m={m}: {err} from the plain "
          "version")
    ms = time_ms(lambda: ops.rescore(cf, cf, probe[0], probe[0], 0.0), 20)
    plain = time_ms(lambda: ref.ref_rescore(cf, cf, probe[0], probe[0], 0.0),
                    5)
    bound, by = bound_ms(4 * (b * c * m + 2 * b * m + b * c),
                         b * c * (3 * 2 * m + 8))
    print(f"[kernel] rescore at d=m={m} (multi-probe, (b, r k') = ({b}, "
          f"{c})): max |err| {err:.3g} in every slot (atol {COS_ATOL}); "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.5f} ms ({by}); "
          f"card {power}")


def phase_lifecycle(dev, power: str, inp: Inputs, flat_ix, bf16_ix):
    """Phase 3h: checkpoints, multi-probe range predicates and the paper's
    baselines at full width. Returns the launch counts of the path (the
    kernel and CPU checks after it are not counted)."""
    q = inp.q_all[:B]
    t_phase = time.perf_counter()
    _build.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="fcvi_ckpt_") as tmp:
        eng = round_trip("3h flat", engine_mod.FCVIEngine(
            flat_ix, engine_mod.EngineConfig(), device=dev),
            os.path.join(tmp, "flat"), inp, dev, power)
        with tempfile.TemporaryDirectory(prefix="fcvi_ckpt_") as tmp_b:
            round_trip("3h flat-bf16", engine_mod.FCVIEngine(
                bf16_ix, engine_mod.EngineConfig(), device=dev), tmp_b,
                inp, dev, power)
        torch.cuda.empty_cache()

        # multi-probe on the restored engine: 512 queries, batches of 64
        pred = price_box(dev)
        eng.search_predicate(inp.q_warm, pred)      # first-call allocations
        lat, served = [], []
        for s in range(0, 512, B):
            t0 = time.perf_counter()
            sv, si = eng.search_predicate(inp.q_all[s:s + B], pred)
            served.append((sv.cpu().numpy(), si.cpu().numpy()))
            lat.append(time.perf_counter() - t0)
        mp_s = np.concatenate([s for s, _ in served])
        mp_i = np.concatenate([i for _, i in served])
        check(np.isfinite(mp_s).all() and ((mp_i >= 0) & (mp_i < N)).all(),
              "3h: multi-probe results out of range")
        print(f"[3h] search_predicate ({PRICE[0]} in [{PRICE[1]}, "
              f"{PRICE[2]}], r={eng.cfg.multi_probe_r}), 512 queries in "
              f"batches of {B}: qps {512 / sum(lat):.1f} batch p50 "
              f"{1e3 * np.percentile(lat, 50):.2f} ms p99 "
              f"{1e3 * np.percentile(lat, 99):.2f} ms; card {power}")

        # the baselines on the raw corpus, and FCVI multi-probe + verify
        v = torch.tensor(inp.corpus.vectors, device=dev)
        fl = torch.tensor(inp.corpus.filters, device=dev)
        raw = flat_mod.build(v)
        hyb = build_hybrid(v, fl, key_dim=int(PRICE[0][1:]), device=dev)
        got = {"pre-filter": [], "post-filter": [], "hybrid": [],
               "FCVI multi-probe + verify": []}
        truth, truth_s = [], []
        for s in range(0, 512, B):
            qb = torch.tensor(inp.q_all[s:s + B], device=dev)
            tv, ti = ground_truth_filtered(v, fl, qb, pred, 11)
            truth_s.append(tv)
            truth.append(ti[:, :10].cpu().numpy())
            got["pre-filter"].append(pre_filter_search(raw, fl, qb, pred, 10))
            got["post-filter"].append(post_filter_search(raw, fl, qb, pred,
                                                         10))
            got["hybrid"].append(hybrid_search(hyb, qb, pred, 10))
            pb = pred.probes(R_PROBES)[None].expand(B, R_PROBES, M)
            _, cids = fcvi.multi_probe_query(eng.index, qb, pb, 200)
            rows = cids.long()
            d2 = torch.sum((v[rows] - qb[:, None, :]) ** 2, dim=-1)
            vs = torch.where(pred.mask(fl[rows]), -d2, float("-inf"))
            top, pos = ref.topk_first(vs, 10)
            got["FCVI multi-probe + verify"].append(
                (top, torch.gather(cids, -1, pos)))
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        print(f"[3h] counts {json.dumps(counts)}")

        truth = np.concatenate(truth)
        recalls = {name: fcvi.recall_at_k(
            np.concatenate([i.cpu().numpy() for _, i in runs]), truth)
            for name, runs in got.items()}
        sel = float(pred.mask(fl).float().mean())
        print(f"[3h] recall@10 against ground_truth_filtered over 512 "
              f"queries, {PRICE[0]} in [{PRICE[1]}, {PRICE[2]}] "
              f"(selectivity {sel:.4f}, n={N}): "
              + ", ".join(f"{k} {r:.4f}" for k, r in recalls.items())
              + f" (FCVI: k=200 multi-probe candidates, r={R_PROBES}, "
              f"verified, ranked by exact distance); card {power}")
        # pre-filtering is exact: the truth's ids outside its near-ties
        # (the truth's expansion q2 - 2 q.v + |v|^2 against the refine's
        # elementwise (q - v)^2: atol 1e-3 covers its fp32 rounding at
        # these norms; the largest difference is printed)
        pre_s = torch.cat([s for s, _ in got["pre-filter"]])
        pre_i = torch.cat([i for _, i in got["pre-filter"]])
        tv = torch.cat(truth_s)
        err = (pre_s - tv[:, :10]).abs().max().item()
        same, kept = ids_outside_ties(tv, torch.tensor(truth), pre_i, 0.0,
                                      1e-3)
        print(f"[3h] pre-filter vs ground_truth_filtered: ids {same}/{kept} "
              f"outside near-ties; max |score diff| {err:.3g}")
        check(err <= 1e-3 and same == kept, "3h: pre_filter_search differs "
              "from ground_truth_filtered")
        del raw, hyb, v, fl, got
        torch.cuda.empty_cache()

        # the first multi-probe batch against a CPU engine on the same
        # checkpoint, and B4 at d = m against its plain version
        probe_rescore(eng.index, torch.tensor(q, device=dev),
                      pred.probes(R_PROBES)[None].expand(B, R_PROBES, M),
                      power)
        t0 = time.perf_counter()
        cpu_eng = engine_mod.FCVIEngine.restore(os.path.join(tmp, "flat"),
                                                device="cpu")
        cs, ci = cpu_eng.search_predicate(q, price_box("cpu"))
        same_top10("3h search_predicate first batch vs CPU engine",
                   mp_s[:B], mp_i[:B], cs.numpy(), ci.numpy().astype(
                       np.int64), np.zeros(B, bool))
        print(f"[3h] CPU engine restored from the same checkpoint: "
              f"{time.perf_counter() - t0:.1f} s")
    print(f"[3h] phase in {time.perf_counter() - t_phase:.1f} s")
    return counts


# -- phase 3i: sharded, routed and degraded serving ----------------------------

SHARDS = 8                   # logical shards, every one on the card
SHARD_CASES = [   # (tag, index, placement, routing, predicate)
    ("flat contiguous dense", "flat", "contiguous", "dense", None),
    ("flat cluster routed", "flat", "cluster", "routed", None),
    ("flat-bf16 contiguous dense", "flat-bf16", "contiguous", "dense", None),
    ("IVF balanced dense", "ivf", "balanced", "dense", None),
    ("IVF balanced routed", "ivf", "balanced", "routed", None),
    ("PQ dense", "pq", "contiguous", "dense", None),
    ("IVF P3 routed over shards", "ivf", "balanced", "dense", "P3"),
]
DEGRADED = ("flat cluster routed", "IVF balanced dense")


def timed_512(eng, inp: Inputs, pred=None):
    """A warm-up batch, then the 512 timed queries in batches of 64
    (predicate search under the routed plan when ``pred`` is given).
    Returns (scores, ids, per-batch seconds)."""
    def call(q, f):
        if pred is None:
            return eng.search(q, f)
        return eng.search(q, filter=pred, plan="routed")

    call(inp.q_warm, inp.f_warm)
    lat, served = [], []
    for s in range(0, 512, B):
        t0 = time.perf_counter()
        served.append(call(inp.q_all[s:s + B], inp.f_all[s:s + B]))
        lat.append(time.perf_counter() - t0)
    return (np.concatenate([a for a, _ in served]),
            np.concatenate([b for _, b in served]), lat)


def lat_str(lat) -> str:
    return (f"qps {512 / sum(lat):.1f} batch p50 "
            f"{1e3 * np.percentile(lat, 50):.2f} ms p99 "
            f"{1e3 * np.percentile(lat, 99):.2f} ms")


def cuda_bytes(obj) -> int:
    """Bytes of the distinct card storages reachable from ``obj`` through
    dataclass fields, tuples, lists and dicts."""
    seen, total, stack = set(), 0, [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            if x.is_cuda and st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


def add_counts(into: dict, counts: dict) -> None:
    for name, n in counts.items():
        into[name] = into.get(name, 0) + n


def degraded_and_heal(tag, eng, inp: Inputs, healthy_ids, dev, power,
                      counts):
    """Shard 3 dead: 128 queries bit-equal to the surviving reference on
    the card, the coverage certificate never under-flags (a query whose
    healthy top-10 held a dead row is flagged); then ``heal`` from a
    checkpoint, and the next 128 queries bit-equal to a meshless restore
    of it, with full coverage."""
    q, f = inp.q_all[:2 * B], inp.f_all[:2 * B]
    eng.health.mark_dead([3])
    _build.reset_launch_counts()
    got = eng.search(q, f)
    torch.cuda.synchronize()
    add_counts(counts, _build.launch_counts())
    cov = eng.stats.last_coverage.copy()
    want = faultinject.surviving_reference(eng).search(q, f)
    check(np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0]),
          f"3i {tag}: degraded results differ from the surviving reference")
    alive = faultinject.surviving_row_mask(eng)
    n = eng.index.size
    affected = np.array([(~alive[r[r < n]]).any()
                         for r in healthy_ids[:2 * B]])
    check(not (affected & cov).any(), f"3i {tag}: a coverage flag missed")
    print(f"[3i] {tag}, shard 3 dead: 128 queries bit-equal to the "
          f"surviving reference; coverage of the call {cov.mean():.4f} "
          f"({int(affected.sum())} queries had a dead row in their healthy "
          f"top-10, {int((~cov).sum())} flagged); stats.coverage_rate "
          f"{eng.stats.coverage_rate:.4f}, degraded batches "
          f"{eng.stats.degraded_batches}")
    q2, f2 = inp.q_all[2 * B:4 * B], inp.f_all[2 * B:4 * B]
    with tempfile.TemporaryDirectory(prefix="fcvi_heal_") as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = eng.heal(tmp, q[:B], f[:B])
        torch.cuda.synchronize()
        heal_s = time.perf_counter() - t0
        check(ok and eng._sharded.n_shards == SHARDS - 1,
              f"3i {tag}: heal did not cut over")
        _build.reset_launch_counts()
        got = eng.search(q2, f2)
        torch.cuda.synchronize()
        add_counts(counts, _build.launch_counts())
        check(eng.stats.last_coverage.all(),
              f"3i {tag}: coverage after heal below 1")
        want = engine_mod.FCVIEngine.restore(tmp, device=dev).search(q2, f2)
        check(np.array_equal(got[1], want[1])
              and np.array_equal(got[0], want[0]),
              f"3i {tag}: healed results differ from a meshless restore")
    print(f"[3i] {tag}: heal (checkpoint, restore onto the {SHARDS - 1} "
          f"surviving shard positions, bit-equal check on 64 probe queries, "
          f"cutover) in {heal_s:.2f} s; the next 128 queries bit-equal to a "
          f"meshless restore, coverage 1.0; card {power}")


def phase_sharded(dev, power: str, inp: Inputs, ix: dict):
    """Phase 3i: the engine over 8 shards on the card (``make_mesh((8,
    1))``: every position is this card), each case's 512 timed queries
    bit-equal to the meshless engine on the same index, timed beside it;
    then shard 3 dead and ``heal`` on two of them. Returns the launch
    counts of the sharded runs (the meshless references are not
    counted)."""
    t_phase = time.perf_counter()
    mesh = make_mesh((SHARDS, 1), ("data", "model"), device=dev)
    attrs = inp.corpus.filters
    counts = {}
    for tag, key, placement, routing, pname in SHARD_CASES:
        index = ix[key]
        pred = None if pname is None else PREDICATES[pname]
        # device memory (GiB): what each engine adds beside the index, and
        # its peak over the timed run above what it holds
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        plain = engine_mod.FCVIEngine(index, engine_mod.EngineConfig(),
                                      device=dev, attributes=attrs)
        m_plain = torch.cuda.memory_allocated() - m0
        torch.cuda.reset_peak_memory_stats()
        ws, wi, wlat = timed_512(plain, inp, pred)
        torch.cuda.synchronize()
        peak_plain = torch.cuda.max_memory_allocated() - m0 - m_plain
        del plain
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = engine_mod.FCVIEngine(index, engine_mod.EngineConfig(),
                                    device=dev, mesh=mesh,
                                    placement=placement, routing=routing,
                                    attributes=attrs)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        m_shard = torch.cuda.memory_allocated() - m0
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        gs, gi, glat = timed_512(eng, inp, pred)
        torch.cuda.synchronize()
        c = _build.launch_counts()
        peak_shard = torch.cuda.max_memory_allocated() - m0 - m_shard
        gib = 2.0 ** 30
        print(f"[3i] {tag} memory, GiB: the index "
              f"{cuda_bytes(index) / gib:.4f} (on the home device, meshless and sharded alike); the "
              f"meshless engine adds {m_plain / gib:.4f}, the {SHARDS}-shard "
              f"engine {m_shard / gib:.4f} (its blocks); peak over the timed "
              f"run above that, meshless {peak_plain / gib:.4f}, sharded "
              f"{peak_shard / gib:.4f}; card {power}")
        add_counts(counts, c)
        check(np.array_equal(gi, wi) and np.array_equal(gs, ws),
              f"3i {tag}: the 8-shard engine differs from the meshless one")
        scans = {k: v for k, v in c.items()
                 if k.startswith(("score_topk", "ivf_score_topk",
                                  "pq_score_topk"))}
        check(sum(scans.values()) > 0, f"3i {tag}: no scan was launched")
        st = eng.stats
        route = ""
        if routing == "routed":
            route = (f"; shard_skip_rate {st.shard_skip_rate:.4f} over "
                     f"{st.routed_batches} batches, router fallbacks "
                     f"{st.router_fallbacks}")
        elif pname is not None:
            route = f"; plan_routed {st.plan_routed}"
        print(f"[3i] {tag} ({SHARDS} shards, placement {placement}): 512 "
              f"queries bit-equal to meshless; sharded {lat_str(glat)} | "
              f"meshless {lat_str(wlat)}; shard build {build_s:.2f} s; "
              f"escalations {st.escalations}{route}; launches a batch (9 "
              f"batches) {json.dumps({k: round(v / 9, 2) for k, v in sorted(c.items())})}; "
              f"card {power}")
        if tag in DEGRADED:
            degraded_and_heal(tag, eng, inp, gi, dev, power, counts)
        del eng
        torch.cuda.empty_cache()
    print(f"[3i] counts {json.dumps(counts)}")
    print(f"[3i] phase in {time.perf_counter() - t_phase:.1f} s")
    return counts


# -- phase 3j: the LM embedder feeding FCVI; prefill and decode --------------

LM_ARCH = "gemma3-1b"        # at its published widths, weights from seed 0
LM_DOCS, LM_SEQ, LM_BATCH = 32768, 128, 256
LM_TOPICS = 6
LM_K = 5                     # the serving example's EngineConfig(k=5)
LM_TIMED = 512
LM_PROMPTS, LM_PROMPT, LM_STEPS = 8, 1024, 32
LM_DRIFT = 0.15              # tests/test_models.py's decode drift bound
LM_COS = 0.9999              # the embeddings' cosine to the plain path
LM_CHECK_DOCS, LM_CHECK_SEQ = 2, 32   # the small input run on the host too


def lm_config():
    return get_config(LM_ARCH)


def lm_corpus(vocab: int):
    """Token documents whose leading block of 8 encodes the topic (the
    serving example's), their filters (topic one-hot + 2 recency columns,
    m = 8) and the generator the queries continue from."""
    r = np.random.default_rng(0)
    topics = r.integers(0, LM_TOPICS, LM_DOCS)
    tokens = r.integers(0, vocab, (LM_DOCS, LM_SEQ)).astype(np.int32)
    tokens[:, :8] = (topics[:, None] * 17 + np.arange(8)) % vocab
    onehot = np.eye(LM_TOPICS, dtype=np.float32)[topics]
    recency = r.uniform(0, 1, (LM_DOCS, 2)).astype(np.float32)
    return topics, tokens, np.concatenate([onehot, recency], axis=1), r


def lm_embed(model, tokens, power: str):
    """(a) the corpus embedded on the card, timed (a batch's warm-up apart),
    with its weights' flops against the bf16 tensor cores' peak; the first
    documents' embeddings held against the host's plain run of the same
    weights."""
    cfg = model.cfg
    lm.pooled_embedding(model, tokens[:LM_BATCH], LM_BATCH)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embs = lm.pooled_embedding(model, tokens, LM_BATCH)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    check(tuple(embs.shape) == (LM_DOCS, cfg.d_model)
          and bool(torch.isfinite(embs).all()),
          f"3j: embeddings are not finite ({LM_DOCS}, {cfg.d_model})")
    n_tok = LM_DOCS * LM_SEQ
    dense = sum(p.numel() for p in model.parameters()) \
        - model.embed.embedding.numel()
    flops = 2.0 * dense * n_tok
    # the attention products, fp32, over each chunk's whole span (masked
    # positions are computed too): QK and PV, 2 flops a multiply-add
    attn_flops = 4.0 * n_tok * LM_SEQ * cfg.n_heads * cfg.head_dim \
        * cfg.n_layers
    print(f"[3j] embedded {LM_DOCS} docs x {LM_SEQ} tokens in batches of "
          f"{LM_BATCH}: {embed_s:.2f} s, {n_tok / embed_s:,.0f} tokens/s; "
          f"the weights' multiply-adds {flops / 1e15:.2f} PFLOP (2 x "
          f"{dense / 1e9:.3f} B non-embedding parameters a token) at "
          f"{flops / embed_s / 1e12:.1f} TFLOP/s = "
          f"{flops / embed_s / PEAK_BF16_S:.1%} of the bf16 dense peak; "
          f"the fp32 attention products {attn_flops / 1e12:.1f} TFLOP "
          f"besides; card {power}")
    one = tokens[:LM_BATCH]
    dev_ms, split, launches = device_time(
        lambda: lm.pooled_embedding(model, one, LM_BATCH), 2)
    wall_ms = 1e3 * embed_s * LM_BATCH / LM_DOCS
    print(f"[3j] a batch of {LM_BATCH} docs: wall {wall_ms:.1f} ms, device "
          f"{dev_ms:.1f} ms (idle {1 - dev_ms / wall_ms:.3f}), {launches} "
          f"launches; {top_kernels(split)}")
    t0 = time.perf_counter()
    small = tokens[:LM_CHECK_DOCS, :LM_CHECK_SEQ]
    host = copy_model(model, "cpu")
    want = lm.pooled_embedding(host, small)
    got = lm.pooled_embedding(model, small).cpu()
    del host
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    check(bool((cos >= LM_COS).all()), f"3j: embeddings on the card vs the "
          f"plain host run: cosine {cos.min().item():.7f} < {LM_COS}")
    print(f"[3j] {LM_CHECK_DOCS} docs x {LM_CHECK_SEQ} tokens on the card "
          f"vs the plain path on the host, the same weights: cosine "
          f"{cos.min().item():.7f} (>= {LM_COS}); "
          f"{time.perf_counter() - t0:.1f} s")
    return embs


def top_kernels(split: dict, n: int = 6) -> str:
    """The ``n`` kernels with the most device time, and the shares of the
    GEMMs (cuBLAS's and CUTLASS's kernels by name: gemm, nvjet, cutlass)
    and of PyTorch's elementwise kernels."""
    total = sum(split.values())

    def share(*tags):
        return sum(v for k, v in split.items()
                   if any(t in k.lower() for t in tags)) / total

    top = sorted(split.items(), key=lambda kv: -kv[1])[:n]
    return (f"of the device time GEMMs {share('gemm', 'nvjet', 'cutlass'):.3f}"
            f", elementwise {share('elementwise'):.3f}; top kernels "
            + "; ".join(f"{k} {v:.2f} ms" for k, v in top))


def copy_model(model, device):
    """The same weights in a model on ``device``."""
    out = lm.Model(model.cfg, torch.device(device))
    out.load_state_dict({k: v.to(device) for k, v in
                         model.state_dict().items()})
    return out


def lm_serve(embs, topics, filters, r, dev, power: str) -> dict:
    """(a) FCVI over the embeddings (d = d_model, m = 8), served as the
    example serves it: 8 shards, cluster placement, routed; the timed
    queries bit-equal to dense and to the meshless engine; inserts; a
    checkpoint round trip. Returns the launch counts of the routed engine's
    run (build, serving, inserts, restore; the references uncounted)."""
    n, d = embs.shape
    q_ids = r.integers(0, n, LM_TIMED + B)
    embs_np = embs.cpu().numpy()
    queries = (embs_np[q_ids] + 0.05 * r.normal(size=(len(q_ids), d))
               ).astype(np.float32)
    fq = filters[q_ids]
    warm = (queries[LM_TIMED:], fq[LM_TIMED:])
    q, f = queries[:LM_TIMED], fq[:LM_TIMED]
    ecfg = engine_mod.EngineConfig(k=LM_K, batch_size=32)
    mesh = make_host_mesh(dev, n_shards=SHARDS)

    def timed(eng):
        eng.search(*warm)
        lat, served = [], []
        for s in range(0, LM_TIMED, B):
            t0 = time.perf_counter()
            served.append(eng.search(q[s:s + B], f[s:s + B]))
            lat.append(time.perf_counter() - t0)
        return (np.concatenate([a for a, _ in served]),
                np.concatenate([b for _, b in served]), lat)

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    index = fcvi.build(embs, torch.tensor(filters, device=dev),
                       fcvi.FCVIConfig(alpha=2.0, lam=0.5, c=8.0), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng = engine_mod.FCVIEngine(index, ecfg, device=dev, mesh=mesh,
                                placement="cluster", routing="routed")
    rs, ri, rlat = timed(eng)
    check(np.isfinite(rs).all() and ((ri >= 0) & (ri < n)).all(),
          "3j: routed results out of range")
    match = float((topics[ri[:, 0]] == topics[q_ids[:LM_TIMED]]).mean())
    st = eng.stats
    eng.insert(embs_np[:64] + 0.01, filters[:64])
    eng.search(q[:16], f[:16])
    check(eng.delta_size() == 64, "3j: the inserts are not pending")
    with tempfile.TemporaryDirectory(prefix="fcvi_lm_") as tmp:
        eng.save(tmp, step=1)
        restored = engine_mod.FCVIEngine.restore(tmp, device=dev, mesh=mesh)
        eng._cache.clear()
        s0, i0 = eng.search(q[:B], f[:B])
        s1, i1 = restored.search(q[:B], f[:B])
        check(np.array_equal(s0, s1) and np.array_equal(i0, i1),
              "3j: the restored engine's results differ")
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    for name in ("fused_transform", "score_topk_rows", "rescore"):
        check(counts.get(name, 0) > 0, f"3j: {name} was not launched")
    print(f"[3j] FCVI flat over {n} embeddings (d={d}, m={filters.shape[1]}) "
          f"built in {build_s:.2f} s; {SHARDS} shards, cluster placement, "
          f"routed: {lat_str(rlat)}; top-1 topic match {match:.4f}; "
          f"shard_skip_rate {st.shard_skip_rate:.4f}, router fallbacks "
          f"{st.router_fallbacks}, escalations {st.escalations}; 64 inserts "
          f"pending, checkpoint round trip identical; card {power}")
    for tag, ref_eng in (
            ("dense", engine_mod.FCVIEngine(index, ecfg, device=dev,
                                            mesh=mesh, placement="cluster",
                                            routing="dense")),
            ("meshless", engine_mod.FCVIEngine(index, ecfg, device=dev))):
        ws, wi, wlat = timed(ref_eng)
        check(np.array_equal(ws, rs) and np.array_equal(wi, ri),
              f"3j: routed results differ from the {tag} engine's")
        print(f"[3j] {tag} engine: {lat_str(wlat)}; the {LM_TIMED} timed "
              f"queries bit-equal to routed")
    print(f"[3j] counts (build, routed serving, inserts, restore) "
          f"{json.dumps(counts)}")
    check(match >= 0.9, f"3j: top-1 topic match {match} below 0.9")
    return counts


def lm_decode(model, power: str) -> None:
    """(b) prefill of 8 prompts of 1024 tokens (the local caches roll past
    the 512 window), then 32 decode steps; each step's logits held to the
    teacher-forced forward's at that position (only there: the full
    logits would be 8.9 GB)."""
    cfg = model.cfg
    r = np.random.default_rng(5)
    toks = r.integers(0, cfg.vocab_size,
                      (LM_PROMPTS, LM_PROMPT + LM_STEPS)).astype(np.int32)
    max_len = LM_PROMPT + LM_STEPS
    prompt = {"tokens": toks[:, :LM_PROMPT]}
    lm.prefill(model, prompt, max_len)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp, cache0 = lm.prefill(model, prompt, max_len)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    local = cache0["self"][cfg.layer_kinds().index("local")]
    size = local["k"].shape[1]
    sp = local["slot_pos"].cpu().numpy()
    check(size < LM_PROMPT and int(sp.min()) == LM_PROMPT - size
          and np.array_equal(sp % size, np.arange(size))
          and int(local["pos"]) == LM_PROMPT,
          f"3j: the local cache did not roll to the last {size} positions")
    run_ms = []
    for run in range(2):          # the first run is the warm-up
        cache, steps = cache0, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(LM_PROMPT, LM_PROMPT + LM_STEPS):
            lg, cache = lm.decode_step(model, toks[:, t:t + 1], cache)
            steps.append(lg[:, 0])
        torch.cuda.synchronize()
        run_ms.append(1e3 * (time.perf_counter() - t0) / LM_STEPS)
    dev_ms, split, launches = device_time(
        lambda: lm.decode_step(model, toks[:, LM_PROMPT:LM_PROMPT + 1],
                               cache0), 4)
    print(f"[3j] a decode step: wall {run_ms[1]:.2f} ms, device "
          f"{dev_ms:.2f} ms (idle {1 - dev_ms / run_ms[1]:.3f}), {launches} "
          f"launches; {top_kernels(split)}")
    h = lm.forward_hidden(model, {"tokens": toks})
    # positions LM_PROMPT - 1 .. max_len - 1: the prefill's, then each step's
    with torch.no_grad():
        full = lm._logits(model, h[:, LM_PROMPT - 1:])
    got = torch.stack([lp[:, 0]] + steps, dim=1)
    errs = (got - full).abs().amax(dim=(0, 2))
    drift = errs.max().item()
    check(bool(torch.isfinite(got).all()), "3j: decode logits not finite")
    check(drift < LM_DRIFT, f"3j: decode drift {drift} >= {LM_DRIFT}")
    pbytes = 4.0 * sum(p.numel() for p in model.parameters())
    bound = 1e3 * pbytes / PEAK_BYTES_S
    prefill_flops = 2.0 * (pbytes / 4 - model.embed.embedding.numel()) \
        * LM_PROMPTS * LM_PROMPT
    print(f"[3j] prefill {LM_PROMPTS} x {LM_PROMPT} tokens: {prefill_ms:.2f} "
          f"ms ({prefill_flops / prefill_ms / 1e9:.1f} TFLOP/s of the "
          f"weights' multiply-adds); decode {run_ms[1]:.3f} ms a step (the "
          f"warm-up run {run_ms[0]:.3f}) beside its bytes bound "
          f"{bound:.3f} ms (the fp32 parameters, {pbytes / 1e9:.2f} GB, "
          f"read once at {PEAK_BYTES_S / 1e12:.2f} TB/s); decode drift "
          f"against the teacher-forced logits, max over {len(errs)} "
          f"positions {drift:.4f} (< {LM_DRIFT}), by position "
          f"{[round(e, 4) for e in errs.tolist()]}; card {power}")


def phase_lm(dev, power: str) -> dict:
    """Phase 3j: gemma3-1b at its published widths with weights from a
    seed: (a) embeds the corpus and feeds FCVI's sharded, routed serving,
    (b) prefill and decode against the teacher-forced forward. Returns (a)'s
    launch counts."""
    t_phase = time.perf_counter()
    cfg = lm_config()
    t0 = time.perf_counter()
    model = lm.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    n = lm.param_count(model)
    print(f"[3j] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n:,} parameters "
          f"({4 * n / 1e9:.2f} GB fp32), drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    topics, tokens, filters, r = lm_corpus(cfg.vocab_size)
    embs = lm_embed(model, tokens, power)
    counts = lm_serve(embs, topics, filters, r, dev, power)
    lm_decode(model, power)
    del model, embs
    torch.cuda.empty_cache()
    print(f"[3j] phase in {time.perf_counter() - t_phase:.1f} s")
    return counts


# -- phase 3k: the MoE, recurrent and encoder-decoder archs ------------------

LMK_ARCHS = ("granite-moe-3b-a800m", "recurrentgemma-2b", "xlstm-125m",
             "whisper-large-v3", "dbrx-132b")
LMK_EMBED = LMK_ARCHS[:3]    # the decoder-only families embed documents
# dbrx-132b at its published widths, depth cut: 132 B fp32 parameters
# (526 GB) cannot fit on one 80 GB card
LMK_LAYERS = {"dbrx-132b": 2}
LMK_DOCS = 4096              # documents of LM_SEQ tokens, batches of LM_BATCH
LMK_FRAMES = 1500            # whisper's 30 s window of encoder frames
LMK_WHISPER_PROMPT = 384     # + LM_STEPS within whisper's 448-token context
LMK_CAPACITY = 8.0           # MoE serving: tests/test_models.py's (no drops)
# the reference's own decode drift at the published widths and depth where
# scripts/lm_drift.py found it above LM_DRIFT, on this phase's sample (8
# prompts of 1024 tokens, 32 steps, the tokens of seed 7; PERF.md): such
# an arch is held to 1.5 times it
LMK_REF_DRIFT = {"xlstm-125m": 0.9273}             # all 12 layers
UNROUNDED = 1.5              # the CPU tests' factor over the reference's
                             # distance from the unrounded function


def lmk_config(arch: str):
    cfg = get_config(arch)
    if arch in LMK_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=LMK_LAYERS[arch])
    return cfg


def moe_flops(cfg, tokens: int) -> float:
    """The experts' multiply-adds of a batch of ``tokens`` tokens in the
    reference's formulation: every one of the E x C dispatch slots runs
    the three expert products."""
    cap = moe_mod.capacity(cfg.moe_capacity_factor, tokens, cfg.moe_top_k,
                           cfg.moe_experts)
    return (2.0 * 3 * cfg.moe_experts * cap * cfg.d_model * cfg.moe_d_ff
            * cfg.n_layers)


def dense_params(model) -> int:
    """The parameters a token multiplies through, the embedding table and
    the experts apart."""
    return sum(p.numel() for n, p in model.named_parameters()
               if n != "embed.embedding" and ".moe.we_" not in n)


def with_routes(fn):
    """(``fn()``, each MoE router call's (probs, experts, keep) in call
    order, on the device they were computed on)."""
    routes, route = [], moe_mod.route

    def record(*a):
        out = route(*a)
        routes.append((out[0], out[2], out[4]))
        return out

    moe_mod.route = record
    try:
        return fn(), routes
    finally:
        moe_mod.route = route


def recorded_routes(model, tokens):
    """(pooled embeddings, each MoE layer's (probs, experts, keep)) of
    ``tokens``, on the host."""
    embs, routes = with_routes(lambda: lm.pooled_embedding(model, tokens))
    return embs.cpu(), [tuple(t.cpu() for t in r) for r in routes]


def unrounded_embedding(model, tokens) -> torch.Tensor:
    """The mean-pooled final hidden states of ``tokens`` computed without
    bf16 rounding (the compute dtype float64 on the model's device; fp32
    where the reference computes fp32), as the CPU tests define the
    unrounded function. Returns (n, d) float64 on the host."""
    hi = lm.Model(model.cfg, torch.device("meta")).double().to_empty(
        device=model.device)
    hi.load_state_dict(model.state_dict())
    keep = lm_layers.COMPUTE_DTYPE
    lm_layers.COMPUTE_DTYPE = torch.float64
    try:
        h = lm.forward_hidden(hi, {"tokens": tokens})
    finally:
        lm_layers.COMPUTE_DTYPE = keep
    del hi
    return h.mean(dim=1).cpu()


def angle(a, b) -> torch.Tensor:
    """The angle between rows of ``a`` and ``b``, radians (float64)."""
    c = torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1)
    return torch.arccos(torch.clamp(c, -1.0, 1.0))


def first_flips(layers, k: int):
    """Routing flips between two computations of the same MoE logits.
    ``layers``: per MoE layer (ref probs, ref experts, probs, experts),
    leading axes alike. A flip is a discontinuity, not a rounding: at a
    router near-tie the two pick different experts, and then differ by an
    expert's whole contribution (and route otherwise downstream). Near-tie
    is measured, not assumed: the two computations' router logits move
    apart by rounding, and the largest change of a logit difference over
    every (token, layer) still routed alike is the reach of that rounding.
    Returns (flipped (leading axes) bool, each flipped token's logit gap
    between the ref's k-th and (k+1)-th experts at its first differing
    layer, the reach)."""
    flipped, gaps, reach = None, [], 0.0
    for p_ref, e_ref, p, e in layers:
        differ = (torch.sort(e_ref, -1).values
                  != torch.sort(e, -1).values).any(-1).cpu()
        if flipped is None:
            flipped = torch.zeros_like(differ)
        # log p differences are logit differences (softmax keeps them)
        lr = torch.log(torch.clamp_min(p_ref, 1e-30))
        moved = torch.log(torch.clamp_min(p, 1e-30)) - lr
        spread = (moved.amax(-1) - moved.amin(-1)).cpu()
        alike = ~differ & ~flipped
        if bool(alike.any()):
            reach = max(reach, float(spread[alike].max()))
        srt = torch.sort(lr, dim=-1, descending=True).values.cpu()
        new = differ & ~flipped
        gaps += (srt[..., k - 1] - srt[..., k])[new].tolist()
        flipped |= new
    return flipped, gaps, reach


def kept_set_report(card_routes, host_routes, top_k: int) -> str:
    """The card's kept (token, expert) pairs against the host's, layer by
    layer, and the tokens routed otherwise, each first at a near-tie
    within rounding's reach (``first_flips``) or not."""
    pairs = 0
    for (_, e_c, k_c), (_, e_h, k_h) in zip(card_routes, host_routes):
        kept_c = {(i // top_k, int(e)) for i, (e, k) in enumerate(
            zip(e_c.reshape(-1), k_c)) if k}
        kept_h = {(i // top_k, int(e)) for i, (e, k) in enumerate(
            zip(e_h.reshape(-1), k_h)) if k}
        pairs += len(kept_c ^ kept_h)
    _, gaps, reach = first_flips(
        [(h[0], h[1], c[0], c[1]) for c, h in zip(card_routes, host_routes)],
        top_k)
    return (f"{pairs} kept (token, expert) pairs differ over "
            f"{len(host_routes)} layers; {len(gaps)} tokens routed otherwise "
            f"in some layer, {sum(g <= reach for g in gaps)} of them first "
            f"at a router near-tie (the host's k-th and (k+1)-th logits "
            f"within {reach:.4f}, the largest change of a logit difference "
            f"of a token routed alike)")


def lmk_embed(model, tokens, power: str):
    """(a) the documents embedded on the card, timed (a batch's warm-up
    apart), the weights' flops against the bf16 dense peak; the first
    documents against the host's plain run of the same weights."""
    cfg = model.cfg
    tag = f"[3k] {cfg.name}:"
    lm.pooled_embedding(model, tokens[:LM_BATCH], LM_BATCH)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embs = lm.pooled_embedding(model, tokens, LM_BATCH)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    n = tokens.shape[0]
    check(tuple(embs.shape) == (n, cfg.d_model)
          and bool(torch.isfinite(embs).all()),
          f"3k: {cfg.name} embeddings are not finite ({n}, {cfg.d_model})")
    n_tok = n * LM_SEQ
    dense = dense_params(model)
    flops = 2.0 * dense * n_tok
    what = f"2 x {dense / 1e9:.3f} B parameters a token"
    if cfg.is_moe:
        expert = moe_flops(cfg, LM_BATCH * LM_SEQ) * (n // LM_BATCH)
        flops += expert
        what += (f" + the experts over all E x C dispatch slots "
                 f"{expert / 1e15:.3f} PFLOP")
    print(f"{tag} embedded {n} docs x {LM_SEQ} tokens in batches of "
          f"{LM_BATCH}: {embed_s:.2f} s, {n_tok / embed_s:,.0f} tokens/s; "
          f"the weights' multiply-adds {flops / 1e15:.3f} PFLOP ({what}) at "
          f"{flops / embed_s / 1e12:.1f} TFLOP/s = "
          f"{flops / embed_s / PEAK_BF16_S:.1%} of the bf16 dense peak; "
          f"card {power}")
    one = tokens[:LM_BATCH]
    dev_ms, split, launches = device_time(
        lambda: lm.pooled_embedding(model, one, LM_BATCH), 1)
    wall_ms = 1e3 * embed_s * LM_BATCH / n
    print(f"{tag} a batch of {LM_BATCH} docs: wall {wall_ms:.1f} ms, device "
          f"{dev_ms:.1f} ms (idle {1 - dev_ms / wall_ms:.3f}), {launches} "
          f"launches; {top_kernels(split)}")
    t0 = time.perf_counter()
    small = tokens[:LM_CHECK_DOCS, :LM_CHECK_SEQ]
    host = copy_model(model, "cpu")
    want, host_routes = recorded_routes(host, small)
    del host
    got, card_routes = recorded_routes(model, small)
    routes = ""
    if cfg.is_moe:
        routes = (f"; at capacity {cfg.moe_capacity_factor}: "
                  + kept_set_report(card_routes, host_routes,
                                    cfg.moe_top_k))
    # both bf16 runs are held to the same function without bf16 rounding:
    # the card no further from it than 1.5 times the host's plain run (the
    # CPU tests' rule)
    exact = unrounded_embedding(model, torch.as_tensor(small,
                                                       device=model.device))
    a_card = angle(got, exact).max().item()
    a_host = angle(want, exact).max().item()
    cos = torch.cos(angle(got, want)).min().item()
    print(f"{tag} {LM_CHECK_DOCS} docs x {LM_CHECK_SEQ} tokens on the card "
          f"and by the plain path on the host, the same weights, against "
          f"the unrounded run: angles {a_card:.5f} (card) and {a_host:.5f} "
          f"(host) rad (the card within {UNROUNDED} x the host's); cosine "
          f"card to host {cos:.7f}{routes}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(a_card <= UNROUNDED * a_host, f"3k: {cfg.name} embeddings: the "
          f"card's angle from the unrounded run {a_card:.5f} > {UNROUNDED} "
          f"x the host's {a_host:.5f}")
    return embs


def lmk_serve(tag, embs, topics, filters, r, dev, power: str) -> dict:
    """(a) meshless FCVI flat over the embeddings (d = d_model, m = 8, the
    serving example's config), 512 timed queries (the documents' own
    embeddings plus noise, their filters). Returns the launch counts of
    the build and the serving."""
    n, d = embs.shape
    q_ids = r.integers(0, n, LM_TIMED + B)
    embs_np = embs.cpu().numpy()
    queries = (embs_np[q_ids] + 0.05 * r.normal(size=(len(q_ids), d))
               ).astype(np.float32)
    fq = filters[q_ids]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    index = fcvi.build(embs, torch.tensor(filters, device=dev),
                       fcvi.FCVIConfig(alpha=2.0, lam=0.5, c=8.0), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng = engine_mod.FCVIEngine(index, engine_mod.EngineConfig(
        k=LM_K, batch_size=32), device=dev)
    eng.search(queries[LM_TIMED:], fq[LM_TIMED:])
    lat, ids = [], []
    for s in range(0, LM_TIMED, B):
        t0 = time.perf_counter()
        ids.append(eng.search(queries[s:s + B], fq[s:s + B])[1])
        lat.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    ids = np.concatenate(ids)
    check(((ids >= 0) & (ids < n)).all(), f"3k: {tag} results out of range")
    match = float((topics[ids[:, 0]] == topics[q_ids[:LM_TIMED]]).mean())
    print(f"[3k] {tag}: FCVI flat over {n} embeddings (d={d}, "
          f"m={filters.shape[1]}) built in {build_s:.2f} s, meshless: "
          f"{lat_str(lat)}; top-1 topic match {match:.4f}; escalations "
          f"{eng.stats.escalations}; launches {json.dumps(counts)}; card "
          f"{power}")
    check(match >= 0.9, f"3k: {tag} top-1 topic match {match} below 0.9")
    for name in ("fused_transform", "score_topk_rows", "rescore"):
        check(counts.get(name, 0) > 0, f"3k: {tag}: {name} was not launched")
    lmk_kernels(tag, index, torch.tensor(queries[:B], device=dev),
                torch.tensor(fq[:B], dtype=torch.float32, device=dev), power)
    return counts


def lmk_kernels(tag, index, q, f, power: str) -> None:
    """B1, B3 and B4 against their plain versions on the first batch of
    timed queries at the served width d, on the inputs the engine gives
    them: the query transform, the flat scan over the index at the
    engine's k' plus the refine pad, and the re-rank of the k' winners.
    The tolerances of phases 3 and 3g: B1 within 1e-5; B3's scores within
    the L2 tolerance plus ``depth_atol``, its ids equal outside near-ties,
    its rows the gathered rows; B4 within COS_ATOL, ids equal outside
    near-ties. Run after the served launches are read: these do not
    count."""
    cfg, be = index.config, index.backend
    b, d = q.shape
    qn, fqn = index.transform.normalize(q, f)
    p, alpha = index.transform.projection(), index.transform.alpha
    q_t = ops.fused_transform(qn, fqn, p, alpha)
    e1 = (q_t - ref.ref_fused_transform(qn, fqn, p, alpha)).abs().max().item()
    check(e1 <= 1e-5, f"3k: {tag} fused_transform ({b}, {d}) error {e1}")
    kp = theory.k_prime(LM_K, cfg.lam, cfg.resolved_alpha(), index.size,
                        cfg.c)
    _, kk = flat_mod._widths(be, kp)
    check(kk < index.size, f"3k: {tag} scan width {kk} >= {index.size}")
    x, sq, vn, fn = be.vectors, be.sq_norms, index.vectors_n, index.filters_n
    vals, ids, rows, rv, rf = ops.score_topk_rows(x, sq, vn, fn, q_t, kk,
                                                  scales=be.scales)
    want = ref.ref_score_topk_rows(x, sq, vn, fn, q_t, kk + 1, be.scales)
    atol = L2_ATOL + depth_atol(q_t, x, d)
    e3 = (vals - want[0][:, :kk]).abs().max().item()
    share = tol_share(vals, want[0][:, :kk], atol)
    a3, t3 = ids_outside_ties(want[0], want[1], ids, L2_RTOL,
                              atol.cpu().numpy())
    idx = ids.long()
    check(share <= 1.0 and a3 == t3, f"3k: {tag} score_topk_rows kk={kk}: "
          f"error {e3} ({share:.3f} of the tolerance), ids {a3}/{t3} outside "
          f"near-ties")
    check(torch.equal(rows, x[idx].float()) and torch.equal(rv, vn[idx])
          and torch.equal(rf, fn[idx]), f"3k: {tag} score_topk_rows kk={kk}: "
          f"rows differ from the gathered rows")
    _, cand, cv, cf = flat_mod.search_rows(be, q_t, kp, vn, fn)
    gv, gi = ops.rescore_topk(cv, cf, qn, fqn, cfg.lam, cand, LM_K)
    pv, pi = ref.ref_rescore_topk(cv, cf, qn, fqn, cfg.lam, cand, LM_K + 1)
    e4 = (gv - pv[:, :LM_K]).abs().max().item()
    a4, t4 = ids_outside_ties(pv, pi, gi, 0.0, COS_ATOL)
    check(e4 <= COS_ATOL and a4 == t4, f"3k: {tag} rescore_topk kp={kp}: "
          f"error {e4}, ids {a4}/{t4} outside near-ties")
    print(f"[3k] {tag}: the first {b} queries at d={d} against the plain "
          f"versions: fused_transform max_abs_err {e1:.3g} (<= 1e-5); "
          f"score_topk_rows kk={kk} max_abs_err {e3:.3g} ({share:.3f} of the "
          f"L2 tolerance with depth_atol), ids {a3}/{t3} outside near-ties, "
          f"rows exact; rescore_topk kp={kp} k={LM_K} max_abs_err {e4:.3g} "
          f"(<= {COS_ATOL}), ids {a4}/{t4} outside near-ties; card {power}")


def lmk_decode(model, power: str) -> tuple:
    """(b) 8 prompts prefilled and 32 steps decoded (MoE at capacity 8.0);
    each step's logits against the teacher-forced forward's at that
    position. An MoE arch's prefill and decode are also teacher-forced in
    their routes: they replay the forward's experts (``replaying``), so
    that a router near-tie cannot send the two computations to different
    experts, and every (prompt, position) pair is held to the bound.
    Returns (drift, bound)."""
    cfg = model.cfg
    tag = f"[3k] {cfg.name}:"
    if cfg.is_moe:
        model.cfg = cfg = dataclasses.replace(
            cfg, moe_capacity_factor=LMK_CAPACITY)
    r = np.random.default_rng(7)
    plen = LMK_WHISPER_PROMPT if cfg.enc_dec else LM_PROMPT
    toks = r.integers(0, cfg.vocab_size,
                      (LM_PROMPTS, plen + LM_STEPS)).astype(np.int32)
    prompt, batch = {"tokens": toks[:, :plen]}, {"tokens": toks}
    if cfg.enc_dec:
        frames = torch.tensor(r.normal(size=(LM_PROMPTS, LMK_FRAMES,
                                             cfg.d_model)).astype(np.float32),
                              device=model.device)
        prompt["frames"] = batch["frames"] = frames
    max_len = plen + LM_STEPS
    h, fwd_routes = with_routes(lambda: lm.forward_hidden(model, batch))
    with torch.no_grad():
        full = lm._logits(model, h[:, plen - 1:])
    del h
    experts = []
    for _, e, keep in fwd_routes:
        check(bool(keep.all()), f"3k: {cfg.name}: the forward dropped pairs "
              f"at capacity {cfg.moe_capacity_factor}")
        experts.append(e.reshape(LM_PROMPTS, max_len, -1))
    # the checked run, which also warms up the timed one
    t0 = time.perf_counter()
    (lp, cache), own = replaying(
        lambda: lm.prefill(model, prompt, max_len),
        [e[:, :plen] for e in experts])
    otherwise = own[:, -1:]
    steps = []
    for t in range(plen, max_len):
        (lg, cache), own = replaying(
            lambda: lm.decode_step(model, toks[:, t:t + 1], cache),
            [e[:, t:t + 1] for e in experts])
        steps.append(lg[:, 0])
        otherwise = torch.cat([otherwise, own], dim=1)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    del cache
    got = torch.stack([lp[:, 0]] + steps, dim=1)
    check(bool(torch.isfinite(got).all()), f"3k: {cfg.name} decode logits "
          "not finite")
    errs = (got - full).abs().amax(dim=2).amax(dim=0)    # by position
    del got, full, lp, steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache0 = lm.prefill(model, prompt, max_len)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    cache = cache0
    t0 = time.perf_counter()
    for t in range(plen, max_len):
        _, cache = lm.decode_step(model, toks[:, t:t + 1], cache)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / LM_STEPS
    dev_ms, split, launches = device_time(
        lambda: lm.decode_step(model, toks[:, plen:plen + 1], cache0), 4)
    print(f"{tag} a decode step: wall {step_ms:.2f} ms, device "
          f"{dev_ms:.2f} ms (idle {1 - dev_ms / step_ms:.3f}), {launches} "
          f"launches; {top_kernels(split)}")
    drift = errs.max().item()
    bound = LM_DRIFT
    if cfg.name in LMK_REF_DRIFT:
        bound = max(LM_DRIFT, 1.5 * LMK_REF_DRIFT[cfg.name])
    check(drift < bound, f"3k: {cfg.name} decode drift {drift} >= {bound}")
    forced = ""
    if cfg.is_moe:
        forced = (f"; routes teacher-forced: the router's own top-{cfg.moe_top_k}"
                  f" differs from the forward's in some layer at "
                  f"{int(otherwise.sum())} of {otherwise.numel()} (prompt, "
                  f"position) pairs, all compared")
    pbytes = 4.0 * lm.param_count(model)
    cross = 0.0
    if cache0["cross"] is not None:
        cross = float(sum(t.numel() * t.element_size()
                          for kv in cache0["cross"] for t in kv))
    step_bound = 1e3 * (pbytes + cross) / PEAK_BYTES_S
    print(f"{tag} prefill {LM_PROMPTS} x {plen} tokens"
          + (f" after {LMK_FRAMES} encoded frames" if cfg.enc_dec else "")
          + f": {prefill_ms:.2f} ms; decode {step_ms:.3f} ms a step (the "
          f"checked run, prefill and decode, {check_s:.2f} s) beside its "
          f"bytes bound {step_bound:.3f} ms (the fp32 parameters, "
          f"{pbytes / 1e9:.2f} GB"
          + (f", and the cross caches, {cross / 1e9:.2f} GB," if cross
             else "")
          + f" read once at {PEAK_BYTES_S / 1e12:.2f} TB/s); decode drift "
          f"against the teacher-forced logits, max over {len(errs)} "
          f"positions {drift:.4f} (< {bound:.4f}"
          + (f", 1.5 x the reference's own {LMK_REF_DRIFT[cfg.name]:.4f}"
             if cfg.name in LMK_REF_DRIFT else "")
          + f"), by position {[round(e, 4) for e in errs.tolist()]}"
          f"{forced}; card {power}")
    return drift, bound


def replaying(fn, experts):
    """(``fn()``, (prompts, positions) bool: where the router's own top-k
    set differs from the replayed one in some MoE layer). Each MoE router
    call in ``fn``, in call order, takes its experts from ``experts`` (per
    MoE layer, (prompts, positions, K) of the forward's choices) in place
    of its own top-k; the gates are its own probabilities at those experts,
    renormalised as ``moe.route`` does, and the slots follow from the
    experts. No MoE layer: ``fn()`` as it is."""
    route, calls = moe_mod.route, []

    def replay(p, xt, top_k, cap):
        probs, _, own, _, _ = route(p, xt, top_k, cap)
        e = experts[len(calls)].reshape(own.shape)
        calls.append((torch.sort(own, -1).values
                      != torch.sort(e, -1).values).any(-1))
        gates = torch.gather(probs, -1, e)
        gates = gates / torch.clamp_min(torch.sum(gates, -1, keepdim=True),
                                        1e-9)
        pos, keep = moe_mod.slots(e, p.w_router.shape[-1], cap)
        return probs, gates, e, pos, keep

    moe_mod.route = replay
    try:
        out = fn()
    finally:
        moe_mod.route = route
    check(len(calls) == len(experts), f"3k: {len(calls)} MoE router calls "
          f"replayed {len(experts)} layers' routes")
    b, s = experts[0].shape[:2] if experts else (LM_PROMPTS, 1)
    differ = torch.zeros((b, s), dtype=torch.bool)
    for c in calls:
        differ |= c.reshape(b, s).cpu()
    return out, differ


def rglru_scan_cost(cfg, dev) -> None:
    """What the RG-LRU scan's form costs on the card: one layer's scan over
    a prefill of LM_PROMPTS x LM_PROMPT positions (the reference's
    associative-scan recursion, O(log s) rounds), beside the launches a
    loop over positions would take (about 3 a position)."""
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (LM_PROMPTS, LM_PROMPT, cfg.d_rnn)
    a = torch.rand(shape, generator=g, device=dev)
    bx = torch.randn(shape, generator=g, device=dev)
    dev_ms, _, launches = device_time(lambda: rec_mod.rglru_scan(a, bx), 3)
    n_rec = cfg.layer_kinds().count("rec")
    print(f"[3k] {cfg.name}: the RG-LRU scan of one layer's prefill "
          f"({LM_PROMPTS} x {LM_PROMPT} x {cfg.d_rnn}): {launches} launches, "
          f"device {dev_ms:.3f} ms; {launches * n_rec} over its {n_rec} rec "
          f"layers, where a loop over positions would launch about "
          f"{3 * LM_PROMPT} a layer, {3 * LM_PROMPT * n_rec} in all")


def phase_lm_families(dev, power: str) -> dict:
    """Phase 3k: granite-moe-3b-a800m, recurrentgemma-2b, xlstm-125m,
    whisper-large-v3 and dbrx-132b (depth cut to 2) at their published
    widths, weights drawn on the card from seed 0, one at a time: (a) the
    decoder-only three embed 4,096 documents and feed meshless FCVI, (b)
    all five prefill and decode against the teacher-forced forward.
    Returns (a)'s launch counts, summed."""
    t_phase = time.perf_counter()
    counts: dict = {}
    for arch in LMK_ARCHS:
        t_arch = time.perf_counter()
        cfg = lmk_config(arch)
        t0 = time.perf_counter()
        model = lm.init_params(0, cfg, device=dev)
        torch.cuda.synchronize()
        n = lm.param_count(model)
        cut = ""
        if arch in LMK_LAYERS:
            full = lm.param_count(lm.init_params(0, get_config(arch),
                                                 device="meta"))
            cut = (f"; depth cut from {get_config(arch).n_layers} layers "
                   f"({full:,} parameters, {4 * full / 1e9:.0f} GB fp32) to "
                   f"{cfg.n_layers}")
        print(f"[3k] {cfg.name}: {cfg.n_layers} layers {cfg.pattern}, "
              f"d_model {cfg.d_model}, {cfg.n_heads} heads / "
              f"{cfg.n_kv_heads} KV of {cfg.head_dim}, d_ff {cfg.d_ff}, "
              f"vocab {cfg.vocab_size}"
              + (f", {cfg.moe_experts} experts top-{cfg.moe_top_k} of "
                 f"d_ff {cfg.moe_d_ff}" if cfg.is_moe else "")
              + (f", {cfg.n_enc_layers} encoder layers" if cfg.enc_dec
                 else "")
              + f": {n:,} parameters ({4 * n / 1e9:.2f} GB fp32), drawn on "
              f"the card in {time.perf_counter() - t0:.2f} s{cut}")
        if arch in LMK_EMBED:
            topics, tokens, filters, r = lm_corpus(cfg.vocab_size)
            embs = lmk_embed(model, tokens[:LMK_DOCS], power)
            add_counts(counts, lmk_serve(cfg.name, embs, topics[:LMK_DOCS],
                                         filters[:LMK_DOCS], r, dev, power))
            del embs
        lmk_decode(model, power)
        if "rec" in cfg.pattern:
            rglru_scan_cost(cfg, dev)
        del model
        torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[3k] {cfg.name} in {time.perf_counter() - t_arch:.1f} s; "
              f"peak device memory {peak:.1f} GiB")
        torch.cuda.reset_peak_memory_stats()
    print(f"[3k] counts (builds and serving) {json.dumps(counts)}")
    print(f"[3k] phase in {time.perf_counter() - t_phase:.1f} s")
    return counts


# -- phase 3l: training ------------------------------------------------------

TRAIN_ARCH = "gemma3-1b"     # at its published widths, weights from seed 0
TRAIN_PARAMS = 1_009_397_376
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 12
TRAIN_LR = 1e-3              # warmup TRAIN_STEPS // 10, cosine to the end
TRAIN_CKPT = TRAIN_STEPS    # one checkpoint, at the end of (a): a 16.2 GB
                             # save or restore takes about 30 s here
MICRO_ATOL = 5e-3            # the reference's microbatching bound
# predicted peak device memory of a step at 8 x 1024 (PERF.md, written
# before the first run): fp32 params, grads, mu, nu and master (5 x 4.04
# GB), the update's new state beside the old and the clipped grads (4 x
# 4.04 GB), or in the backward one loss chunk's fp32 logits, their exp and
# their gradient (3 x 4.3 GB) with the widened unembedding weights
TRAIN_PREDICTED_GB = 42.0
TRAIN_FAMILIES = ("gemma3-1b", "granite-moe-3b-a800m", "recurrentgemma-2b",
                  "xlstm-125m", "whisper-large-v3")


def train_argv(ckpt_dir: str, steps: int = TRAIN_STEPS) -> list:
    return ["--arch", TRAIN_ARCH, "--full-config", "--steps", str(steps),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--lr", str(TRAIN_LR), "--ckpt-dir", ckpt_dir,
            "--ckpt-every", str(TRAIN_CKPT), "--device", "cuda"]


def train_batch(cfg, index: int, dev) -> dict:
    """The launcher's token stream's batch ``index`` on the card."""
    data = global_batch_iterator(TokenSpec(
        vocab_size=cfg.vocab_size, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        seed=0), train_launch.batch_extras(cfg))
    for _ in range(index):
        next(data)
    return {k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}


def train_report(out: dict, power: str) -> float:
    """(a)'s checks and numbers: finite and falling loss, ms a step,
    tokens/s, the bf16 peak share, peak device memory. Returns the median
    ms a step."""
    losses, gnorms = out["losses"], out["grad_norms"]
    check(len(losses) == TRAIN_STEPS and all(
        np.isfinite(losses + gnorms)), f"3l: a loss or grad norm is not "
        f"finite: {losses} {gnorms}")
    tail = float(np.mean(losses[-5:]))
    check(tail < losses[0], f"3l: the loss did not fall: step 0 "
          f"{losses[0]:.4f}, the last 5 steps' mean {tail:.4f}")
    steady = out["step_s"][1:]                 # step 0 warms up
    step_s = float(np.median(steady))
    tokens = out["tokens_per_step"]
    n = out["params"]
    print(f"[3l] losses {' '.join(f'{x:.4f}' for x in losses)}; grad norms "
          f"{' '.join(f'{x:.3f}' for x in gnorms)}")
    print(f"[3l] loss {losses[0]:.4f} at step 0 -> {tail:.4f} (the last 5 "
          f"steps' mean); step 0 {1e3 * out['step_s'][0]:.1f} ms (warm-up), "
          f"then median {1e3 * step_s:.1f} ms a step (min "
          f"{1e3 * min(steady):.1f}, max {1e3 * max(steady):.1f}) = "
          f"{tokens / step_s:,.0f} tokens/s; 6 N T = "
          f"{6 * n * tokens / 1e12:.1f} TFLOP a step = "
          f"{6 * n * tokens / step_s / PEAK_BF16_S:.1%} of the bf16 dense "
          f"peak, 8 N T with the recompute "
          f"{8 * n * tokens / step_s / PEAK_BF16_S:.1%} (N = {n:,}, T = "
          f"{tokens}); card {power}")
    return 1e3 * step_s


def train_adamw():
    """The launcher's AdamW config for the resumed run of (c)
    (``train_argv`` with ``TRAIN_STEPS + 1`` steps), the schedule every
    step after (a) runs by; step ``TRAIN_STEPS``'s loss comes before its
    update and does not depend on it."""
    return train_opt.AdamWConfig(lr=TRAIN_LR,
                                 warmup_steps=max((TRAIN_STEPS + 1) // 10, 1),
                                 total_steps=TRAIN_STEPS + 1)


def train_resume_check(resumed: dict, loss_next: float, nxt) -> None:
    """(c): ``launch.train.main --steps 13 --resume`` restored the step-12
    checkpoint into a fresh model and state and took step 12 through its
    own token stream and loop: its loss is the uninterrupted run's next
    loss bit for bit, and its params, mu, nu, master and step after it
    are the uninterrupted run's (``nxt``: the state after (b)'s n_micro =
    1 step, whose fp32 master the params are) bit for bit."""
    same = all(torch.equal(p, nxt.master[k])
               for k, p in resumed["model"].named_parameters())
    for field in ("mu", "nu", "master"):
        mine = getattr(resumed["state"], field)
        ref_ = getattr(nxt, field)
        same &= sorted(mine) == sorted(ref_) and all(
            torch.equal(mine[k], ref_[k]) for k in ref_)
    same &= int(resumed["state"].step) == int(nxt.step) == TRAIN_STEPS + 1
    check(resumed["start"] == TRAIN_STEPS and len(resumed["losses"]) == 1,
          f"3l: launch.train.main --resume started at step "
          f"{resumed['start']} and took {len(resumed['losses'])} steps")
    check(resumed["losses"][0] == loss_next, f"3l: the resumed launcher's "
          f"step-{TRAIN_STEPS} loss {resumed['losses'][0]!r} is not the "
          f"uninterrupted run's {loss_next!r} bit for bit")
    check(same, "3l: the params, mu, nu, master or step after the resumed "
          "launcher's step differ from the uninterrupted run's")


def train_step_loss(model, state, batch, n_micro: int = 1) -> tuple:
    """(loss, seconds, the new state) of one step of ``train_adamw``; the
    model's params move."""
    step = train_loop.make_train_step(model.cfg, train_adamw(),
                                      n_micro=n_micro)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, new_state, m = step(model, state, batch)
    loss = float(m["loss"])
    return loss, time.perf_counter() - t0, new_state


def train_micro(out: dict, batch, power: str) -> tuple:
    """(b) one step at n_micro = 2 against one at n_micro = 1 from the
    trained state, on the stream's next batch; then one step's device time
    by kernel. Takes the trained state out of ``out`` (so that the card
    holds one optimizer state beside the step's); returns the n_micro = 1
    step's loss and the state after it: the uninterrupted run's next
    step (its params are that state's fp32 master)."""
    model, state = out["model"], out.pop("state")
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    loss2, secs2, _ = train_step_loss(model, state, batch, 2)
    after2 = {k: p.detach().clone() for k, p in params.items()}
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(start[k])
    del start
    loss, secs, nxt = train_step_loss(model, state, batch, 1)
    del state
    d = max(float((p.detach() - after2[k]).abs().max())
            for k, p in params.items())
    del after2
    print(f"[3l] (b) n_micro=2 against n_micro=1 from the same state and "
          f"batch: max |d param| {d:.3e} (< {MICRO_ATOL}); loss "
          f"{loss:.6f} / {loss2:.6f}; step {1e3 * secs:.1f} / "
          f"{1e3 * secs2:.1f} ms")
    check(d < MICRO_ATOL, f"3l: microbatching moved a param {d:.3e} from "
          f"the one-batch step (>= {MICRO_ATOL})")
    torch.cuda.empty_cache()
    step = train_loop.make_train_step(model.cfg, train_adamw())
    dev_ms, split, launches = device_time(
        lambda: step(model, nxt, batch), 1)
    print(f"[3l] one step by kernel: device {dev_ms:.1f} ms, {launches} "
          f"launches; {top_kernels(split, 8)}; card {power}")
    return loss, nxt


def grads_of(model, batch, unrounded: bool = False) -> torch.Tensor:
    """The loss's gradient over every param, flattened, float64 on the
    host; ``unrounded``: a float64 copy of the model with the compute dtype
    float64 (fp32 where the reference computes fp32)."""
    if unrounded:
        hi = lm.Model(model.cfg, torch.device("meta")).double().to_empty(
            device=model.device)
        hi.load_state_dict(model.state_dict())
        model = hi
    keep = lm_layers.COMPUTE_DTYPE
    if unrounded:
        lm_layers.COMPUTE_DTYPE = torch.float64
    try:
        with torch.enable_grad():
            loss, _ = lm.lm_loss(model, batch)
            grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        lm_layers.COMPUTE_DTYPE = keep
    return torch.cat([g.double().reshape(-1).cpu() for g in grads])


def train_families(dev) -> None:
    """(d) reduced gradients on the card against the host, one arch of each
    family: the card's no further from its own unrounded gradient than
    1.5 times the host's from the host's."""
    for arch in TRAIN_FAMILIES:
        cfg = reduced(get_config(arch))
        model = lm.init_params(0, cfg, device=dev)
        host = copy_model(model, "cpu")
        r = np.random.default_rng(0)
        batch = {"tokens": r.integers(0, cfg.vocab_size, (2, 64))
                 .astype(np.int32)}
        batch.update({k: r.normal(size=(2, *shape)).astype(np.float32)
                      for k, shape in train_launch.batch_extras(cfg).items()})
        card_b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        host_b = {k: torch.as_tensor(v) for k, v in batch.items()}
        g_card, g_card64 = grads_of(model, card_b), grads_of(model, card_b,
                                                             True)
        g_host, g_host64 = grads_of(host, host_b), grads_of(host, host_b,
                                                            True)
        d_card = float(torch.linalg.norm(g_card - g_card64))
        d_host = float(torch.linalg.norm(g_host - g_host64))
        rel = d_card / float(torch.linalg.norm(g_card64))
        print(f"[3l] (d) {cfg.name} reduced: |card - card unrounded| "
              f"{d_card:.4e} ({rel:.2e} of its norm), |host - host "
              f"unrounded| {d_host:.4e}: ratio {d_card / d_host:.3f} (<= "
              f"{UNROUNDED}); card to host {float(torch.linalg.norm(g_card - g_host)):.4e}")
        check(bool(torch.isfinite(g_card).all())
              and d_card <= UNROUNDED * d_host, f"3l: {cfg.name}'s gradient "
              f"on the card lies {d_card:.4e} from its unrounded one, more "
              f"than {UNROUNDED} x the host's {d_host:.4e}")


def phase_train(dev, power: str) -> tuple:
    """Phase 3l: gemma3-1b at its published widths trained through the
    launcher (``launch.train.main``): (a) 12 steps of 8 x 1024 Markov
    tokens, remat on, a checkpoint at the end, (b) microbatching on the
    stream's next batch, (c) ``--steps 13 --resume`` from the checkpoint
    into a fresh model and state, its step held to (b)'s n_micro = 1 step,
    (d) reduced gradients of each family against the host.
    Returns the launch counts of the port's kernels in training (none: no
    TPU kernel lies on this path) and (a)'s median ms a step."""
    t_phase = time.perf_counter()
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="fcvi_train_") as tmp:
        t0 = time.perf_counter()
        out = train_launch.main(train_argv(tmp))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        cfg = out["model"].cfg
        check(cfg.remat and out["params"] == TRAIN_PARAMS,
              f"3l: {cfg.name} at {out['params']:,} parameters, remat "
              f"{cfg.remat}")
        print(f"[3l] {cfg.name}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab_size}, {out['params']:,} "
              f"parameters, remat on; launch.train.main: {TRAIN_STEPS} steps "
              f"of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, lr {TRAIN_LR}, a "
              f"checkpoint at step {TRAIN_CKPT}: {run_s:.1f} s in all; the "
              f"port's kernels launched {json.dumps(counts)}")
        step_ms = train_report(out, power)
        print(f"[3l] peak device memory {peak:.2f} GB "
              f"(torch.cuda.max_memory_allocated; predicted "
              f"{TRAIN_PREDICTED_GB:.0f} GB); the checkpoint (params and "
              f"AdamWState, {dir_bytes(out['checkpoints'][0]) / 1e9:.2f} GB "
              f"on disk) saved in {out['ckpt_s'][0]:.1f} s; card {power}")
        batch = train_batch(cfg, TRAIN_STEPS, dev)
        loss_next, nxt = train_micro(out, batch, power)
        del out, batch
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed = train_launch.main(train_argv(tmp, TRAIN_STEPS + 1)
                                    + ["--resume"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        train_resume_check(resumed, loss_next, nxt)
        print(f"[3l] (c) launch.train.main --steps {TRAIN_STEPS + 1} "
              f"--resume: a fresh model and state restored from step "
              f"{TRAIN_CKPT} and one step in {resume_s:.1f} s (the model "
              f"drawn, the checkpoint read, verified and copied to the card, "
              f"the stream moved on); its step-{TRAIN_STEPS} loss "
              f"{resumed['losses'][0]:.6f}, and the params, mu, nu, master "
              f"and step after it, bit-equal to the uninterrupted run's")
        del resumed, nxt
        torch.cuda.empty_cache()
    train_families(dev)
    print(f"[3l] phase in {time.perf_counter() - t_phase:.1f} s")
    return counts, step_ms


# -- phase 3m: the model's shardings -----------------------------------------

SHARD_SHAPE, SHARD_AXES = (2, 2, 2), ("pod", "data", "model")
SHARD_STEPS = 3
INT8_BOUND = 0.02            # tests/test_compression.py's cross-pod bound
LEAF_FLOOR = 1e-3            # tests/lm_train_support.py's leaf floor
# predictions written in PERF.md before the first run: ms a step and the
# peak memory; the bytes one position holds of params, gradients (ZeRO
# layout) and optimizer state as computed from the specs on the meta device
SHARD_PREDICTED_MS = 4000.0
SHARD_SPEC_GB = (2.019, 1.009, 3.028)
SHARD_PREDICTED_PEAK_GB = 60.0


def unrounded_rule(port: dict, ref: dict, exact: dict, base=None,
                   leaf_atol: float = 0.0) -> tuple:
    """``tests/lm_train_support.py``'s ``within_unrounded`` without its
    anchor (the CPU tests hold the port's unrounded step to the
    reference's): ``port`` no further from ``ref`` than 1.5 times
    ``ref``'s distance from ``exact``, over all leaves and leaf by leaf (a
    leaf's bound at least ``LEAF_FLOOR`` of its norm, of its step from
    ``base`` where given, raised by ``leaf_atol``), in float64 on the card.
    Returns (the global ratio, the worst leaf's |port - ref| over its
    bound, its name)."""
    d_pr = d_re = 0.0
    worst = (0.0, None)
    for k in sorted(exact):
        p, r, e = (t[k].double() for t in (port, ref, exact))
        if base is not None:
            p, r, e = (t - base[k].double() for t in (p, r, e))
        a = float(torch.linalg.norm(p - r))
        b = float(torch.linalg.norm(r - e))
        d_pr, d_re = d_pr + a * a, d_re + b * b
        bound = max(UNROUNDED * b, LEAF_FLOOR * float(torch.linalg.norm(e)))
        worst = max(worst, (a / (bound + leaf_atol), k))
    return (d_pr / d_re) ** 0.5, *worst


def scalar_rule(s: float, u: float, x: float) -> bool:
    """A metric by the rule: within 1.5 times the unsharded value's
    distance from the unrounded one, or ``LEAF_FLOOR`` of it."""
    return abs(s - u) <= max(UNROUNDED * abs(u - x), LEAF_FLOOR * abs(x))


def unrounded_grads(model, batch) -> tuple:
    """(loss, {name: gradient}) of a float64 copy of ``model`` with the
    compute dtype float64 (fp32 where the reference computes fp32); the
    gradient kept in fp32 (its rounding, 6e-8, lies far below bf16's)."""
    hi = lm.Model(model.cfg, torch.device("meta")).double().to_empty(
        device=model.device)
    hi.load_state_dict(model.state_dict())
    keep = lm_layers.COMPUTE_DTYPE
    lm_layers.COMPUTE_DTYPE = torch.float64
    try:
        (loss, _), grads = train_loop._grads(
            train_loop.make_loss_fn(model.cfg), hi, batch)
    finally:
        lm_layers.COMPUTE_DTYPE = keep
    del hi
    return float(loss), {k: g.float() for k, g in grads.items()}


def shard_bytes(tree: dict) -> float:
    return train_loop.per_position_bytes(tree) / 1e9


def colls_str(colls: dict, n: int) -> str:
    """A step's collective bytes a position (the mesh total over ``n``),
    by kind and axis."""
    return "; ".join(
        f"{kind} {rec['bytes'] / n / 1e9:.3f} GB in {rec['count']} calls ("
        + ", ".join(f"{a or '-'} {b / n / 1e9:.3f}" for a, b in
                    sorted(rec["by_axis"].items())) + ")"
        for kind, rec in sorted(colls.items()))


def shard_held_step(model, batch, rules, adamw, power: str) -> None:
    """(a) Step 0 from the seed-0 state, sharded and not: the loss and the
    gradient norm by the rule against the unsharded step and its unrounded
    twin; the synced gradient (the pod hop in fp32) by the rule leaf by
    leaf; the int8 hop's synced gradient within 0.02 of each leaf's max
    from the fp32 hop's; the new params within 2 lr of the unsharded
    step's (Adam's first update is lr times the gradient's sign, so this
    bounds the hop's flips only: (c) holds the update)."""
    cfg = model.cfg
    named = dict(model.named_parameters())
    t0 = time.perf_counter()
    (loss_u, _), g_u = train_loop._grads(train_loop.make_loss_fn(cfg),
                                         model, batch)
    new_u, _, m_u = train_opt.update(adamw, g_u, train_opt.init(named),
                                     named)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    loss_u, gnorm_u = float(loss_u), float(m_u["grad_norm"])
    t0 = time.perf_counter()
    loss_x, g_x = unrounded_grads(model, batch)
    gnorm_x = float(train_opt.global_norm(g_x))
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    params, state, zspecs = train_loop.place_train_state(
        model, train_opt.init(named), rules)
    structure = lm.Model(cfg, torch.device("meta"))
    stats = S.CollectiveStats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with S.use_rules(rules):
        grads, metrics = train_loop.sharded_grads(
            cfg, structure, params, train_loop.place_batch(batch, rules),
            rules, 1, stats)
        synced = {int8: train_loop.sync_grads(
            grads, params, rules, zspecs,
            torch.Generator(device=model.device).manual_seed(0), int8, stats)
            for int8 in (True, False)}
    del grads
    torch.cuda.synchronize()
    grads_s = time.perf_counter() - t0
    loss_s = float(metrics["loss"])
    g32 = {k: S.join(v) for k, v in synced[False].items()}
    ratio, leaf_ratio, leaf = unrounded_rule(g32, g_u, g_x)
    hop = max(float((S.join(synced[True][k]) - g).abs().max())
              / float(g.abs().max()) for k, g in g32.items())
    del g32, g_x, synced[False]
    new_s, _, m_s = train_loop.sharded_update(adamw, synced[True], state,
                                              params, stats)
    gnorm_s = float(m_s["grad_norm"])
    lr = float(m_u["lr"])
    flips, d_max = 0, 0.0
    for k, p in new_u.items():
        d = (S.join(new_s[k]) - p).abs()
        d_max = max(d_max, float(d.max()))
        flips += int((d > lr).sum())
    n = sum(p.numel() for p in named.values())
    print(f"[3m] (a) step 0 from the seed-0 state: loss sharded "
          f"{loss_s:.6f} / unsharded {loss_u:.6f} / unrounded {loss_x:.6f};"
          f" grad norm {gnorm_s:.6f} / {gnorm_u:.6f} / {gnorm_x:.6f}; the "
          f"synced gradient (fp32 hop) against the unsharded one: "
          f"{ratio:.3f} of the unsharded one's distance from unrounded, "
          f"worst leaf {leaf_ratio:.3f} ({leaf}) (<= 1); the int8 hop "
          f"{hop:.5f} of a leaf's max from the fp32 hop (<= {INT8_BOUND}); "
          f"params after the step within {d_max:.3e} of the unsharded "
          f"step's (<= 2 lr = {2 * lr:.3e}), {flips:,} of {n:,} flipped "
          f"by more than lr; seconds: unsharded {plain_s:.1f}, unrounded "
          f"{exact_s:.1f}, sharded gradients and both syncs {grads_s:.1f}; "
          f"card {power}")
    check(np.isfinite(loss_s) and scalar_rule(loss_s, loss_u, loss_x),
          f"3m: sharded step-0 loss {loss_s} against {loss_u} (unrounded "
          f"{loss_x})")
    check(scalar_rule(gnorm_s, gnorm_u, gnorm_x), f"3m: sharded grad norm "
          f"{gnorm_s} against {gnorm_u} (unrounded {gnorm_x})")
    check(ratio <= 1.0 and leaf_ratio <= 1.0, f"3m: the sharded gradient "
          f"lies {ratio:.3f} (worst leaf {leaf_ratio:.3f}, {leaf}) of the "
          "bound from the unsharded one")
    check(hop <= INT8_BOUND, f"3m: the int8 pod hop moved a leaf {hop:.4f} "
          f"of its max (> {INT8_BOUND})")
    check(d_max <= 2 * lr * (1 + 1e-3), f"3m: a param moved {d_max:.3e} "
          f"from the unsharded step's (> 2 lr = {2 * lr:.3e})")


def shard_timed_steps(model, cfg, rules, adamw, power: str,
                      train_ms: float) -> None:
    """(b) ``SHARD_STEPS`` steps of the public step function from the
    seed-0 state on the stream's batches 0, 1, ...: finite losses, ms a
    step, the bytes a position holds of params and optimizer state, the
    collective bytes a step. Returns ``{"params", "state"}``, the placed
    state after the steps."""
    named = dict(model.named_parameters())
    params, state, zspecs = train_loop.place_train_state(
        model, train_opt.init(named), rules)
    step = train_loop.make_train_step(cfg, adamw, grad_shardings=zspecs)
    losses, secs, gnorms = [], [], []
    held = dict(params=shard_bytes(params),
                state=sum(shard_bytes(getattr(state, f))
                          for f in ("mu", "nu", "master")))
    colls = None
    for i in range(SHARD_STEPS):
        batch = train_batch(cfg, i, model.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with S.use_rules(rules):
            params, state, m = step(params, state,
                                    train_loop.place_batch(batch, rules))
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        gnorms.append(float(m["grad_norm"]))
        colls = m["collectives"]
    full = sum(p.numel() * 4 for p in named.values()) / 1e9
    step_ms = 1e3 * float(np.median(secs[1:]))
    print(f"[3m] (b) {SHARD_STEPS} sharded steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens: losses {' '.join(f'{x:.4f}' for x in losses)}"
          f", grad norms {' '.join(f'{x:.3f}' for x in gnorms)}; step 0 "
          f"{1e3 * secs[0]:.1f} ms, then {step_ms:.1f} ms a step (predicted "
          f"{SHARD_PREDICTED_MS:.0f}; 3l's unsharded step "
          f"{train_ms:.1f} ms in this run); card {power}")
    print(f"[3m] bytes a position holds, as separate cards would: params "
          f"{held['params']:.3f} GB, mu + nu + master {held['state']:.3f} "
          f"GB (computed from the specs: {SHARD_SPEC_GB[0]}, "
          f"{SHARD_SPEC_GB[2]}); unsharded {full:.3f} and "
          f"{3 * full:.3f} GB")
    print(f"[3m] collective bytes a position a step: "
          f"{colls_str(colls, rules.mesh.size)}")
    check(all(np.isfinite(losses + gnorms)), f"3m: a sharded loss or grad "
          f"norm is not finite: {losses} {gnorms}")
    pb = train_loop.place_batch(train_batch(cfg, SHARD_STEPS, model.device),
                                rules)

    def one_step():
        with S.use_rules(rules):
            step(params, state, pb)

    dev_ms, split, launches = device_time(one_step, 1)
    print(f"[3m] one step by kernel: device {dev_ms:.1f} ms, {launches} "
          f"launches, idle {1 - dev_ms / step_ms:.2f} of the step; "
          f"{top_kernels(split, 8)}; card {power}")
    return {"params": params, "state": state, "step_ms": step_ms,
            "collectives": colls}


def shard_held_update(placed: dict, cfg, rules, adamw, batch,
                      power: str) -> None:
    """(c) One step from (b)'s state, whose moments are not zero (Adam's
    update is then smooth in the gradient; step 0's is lr times its sign
    whatever the gradient): the sharded step with the pod hop in fp32
    (its three calls: ``sharded_grads``, ``sync_grads``, the ZeRO-1
    ``sharded_update`` on each position's shard of mu, nu and master)
    against the unsharded step from the same joined state, and that step
    with the gradient of a float64 twin, by the rule on each step's
    params less the params before it (the lr-flip allowance of 2 lr a
    leaf, as the CPU tests). Also measures the gradients' bytes a position
    holds before the reduce-scatter and after it. Empties ``placed``
    (the card holds one copy of the state at a time)."""
    params, state = placed.pop("params"), placed.pop("state")
    zspecs = {k: v.spec for k, v in state.mu.items()}
    structure = lm.Model(cfg, torch.device("meta"))
    stats = S.CollectiveStats()
    with S.use_rules(rules):
        grads, metrics = train_loop.sharded_grads(
            cfg, structure, params, train_loop.place_batch(batch, rules),
            rules, 1, stats)
        # position (group 0, model 0): its gradient of each param block
        pre_gb = sum(g[0].numel() * g[0].element_size()
                     for g in grads[0].values()) / 1e9
        synced = train_loop.sync_grads(grads, params, rules, zspecs, None,
                                       False, stats)
    del grads
    post_gb = shard_bytes(synced)
    new_s, _, m_s = train_loop.sharded_update(adamw, synced, state, params,
                                              stats)
    del synced
    loss_s, gnorm_s = float(metrics["loss"]), float(m_s["grad_norm"])
    new_s = {k: S.join(v) for k, v in new_s.items()}
    model, state = train_loop.gather_train_state(params, state, cfg)
    del params
    torch.cuda.empty_cache()
    named = {k: p.detach() for k, p in model.named_parameters()}
    loss_x, g = unrounded_grads(model, batch)
    new_x, _, m_x = train_opt.update(adamw, g, state, named)
    del g
    (loss_u, _), g = train_loop._grads(train_loop.make_loss_fn(cfg), model,
                                       batch)
    new_u, _, m_u = train_opt.update(adamw, g, state, named)
    del g, state
    lr = float(m_u["lr"])
    ratio, leaf_ratio, leaf = unrounded_rule(new_s, new_u, new_x, named,
                                             2 * lr)
    d_su = d_step = 0.0
    for k, p in named.items():
        d_su += float(torch.linalg.norm(new_s[k] - new_u[k])) ** 2
        d_step += float(torch.linalg.norm(new_u[k].double()
                                          - p.double())) ** 2
    frac = (d_su / d_step) ** 0.5
    gnorm_u, gnorm_x = float(m_u["grad_norm"]), float(m_x["grad_norm"])
    print(f"[3m] (c) one step from (b)'s state (moments not zero), the pod "
          f"hop in fp32: loss sharded {loss_s:.6f} / unsharded "
          f"{float(loss_u):.6f} / unrounded {loss_x:.6f}; grad norm "
          f"{gnorm_s:.6f} / {gnorm_u:.6f} / {gnorm_x:.6f}; the new params "
          f"less the old against the unsharded step's: {ratio:.3f} of the "
          f"unsharded step's distance from its float64 twin's (<= "
          f"{UNROUNDED}), worst leaf {leaf_ratio:.3f} of its bound ({leaf})"
          f" (<= 1, 2 lr = {2 * lr:.1e} a leaf allowed); |sharded - "
          f"unsharded| {frac:.3e} of the step's size; card {power}")
    print(f"[3m] gradients a position holds, measured in (c): "
          f"{pre_gb:.3f} GB before the reduce-scatter (its gradient of its "
          f"param blocks, params-sized), {post_gb:.3f} GB after it (ZeRO-1 "
          f"layout; computed from the specs: {SHARD_SPEC_GB[1]})")
    check(np.isfinite(loss_s) and scalar_rule(loss_s, float(loss_u),
                                              loss_x),
          f"3m: sharded loss {loss_s} from (b)'s state against "
          f"{float(loss_u)} (unrounded {loss_x})")
    check(scalar_rule(gnorm_s, gnorm_u, gnorm_x), f"3m: sharded grad norm "
          f"{gnorm_s} from (b)'s state against {gnorm_u} (unrounded "
          f"{gnorm_x})")
    check(ratio <= UNROUNDED and leaf_ratio <= 1.0, f"3m: the sharded "
          f"update from (b)'s state lies {ratio:.3f} (worst leaf "
          f"{leaf_ratio:.3f}, {leaf}) of the bound from the unsharded one")


def shard_heads_case(dev, power: str) -> None:
    """(d) The heads-on-model layout: the reference test's reduced
    mistral-nemo-12b (2 layers, 4 heads, 2 KV heads), 8 x 32 tokens, a (4,
    2) ("data", "model") mesh under the default rules, one sharded step on
    the card against the same step on the host: the card's new params no
    further from the host's than 1.5 times the host's distance from its
    step without bf16 rounding; loss and grad norm within 1e-3."""
    cfg = dataclasses.replace(reduced(get_config("mistral-nemo-12b")),
                              n_layers=2, n_heads=4, n_kv_heads=2)
    adamw = train_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    r = np.random.default_rng(0)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (8, 32))
             .astype(np.int32)}
    host_model = lm.init_params(0, cfg, device="cpu")
    out = {}
    for tag, d, hi in (("card", dev, False), ("host", torch.device("cpu"),
                                              False),
                       ("exact", torch.device("cpu"), True)):
        model = copy_model(host_model, d)
        model = model.double() if hi else model
        rules = S.AxisRules(make_mesh((4, 2), ("data", "model"), device=d))
        params, state, _ = train_loop.place_train_state(
            model, train_opt.init(dict(model.named_parameters())), rules,
            zero1=False)
        keep = lm_layers.COMPUTE_DTYPE
        if hi:
            lm_layers.COMPUTE_DTYPE = torch.float64
        try:
            with S.use_rules(rules):
                new, _, m = train_loop.make_train_step(cfg, adamw)(
                    params, state, train_loop.place_batch(batch, rules, d))
        finally:
            lm_layers.COMPUTE_DTYPE = keep
        out[tag] = (torch.cat([S.join(new[k]).double().cpu().reshape(-1)
                               for k in sorted(new)]),
                    float(m["loss"]), float(m["grad_norm"]))
    (c, lc, gc), (h, lh, gh), (x, _, _) = out["card"], out["host"], \
        out["exact"]
    d_ch = float(torch.linalg.norm(c - h))
    d_hx = float(torch.linalg.norm(h - x))
    print(f"[3m] (d) {cfg.name} reduced, heads on the model axis of a (4, "
          f"2) mesh: |card - host| {d_ch:.4e}, |host - host unrounded| "
          f"{d_hx:.4e}: ratio {d_ch / d_hx:.3f} (<= {UNROUNDED}); loss "
          f"{lc:.6f} / {lh:.6f}, grad norm {gc:.6f} / {gh:.6f}")
    check(bool(torch.isfinite(c).all()) and d_ch <= UNROUNDED * d_hx
          and abs(lc - lh) <= 1e-3 * abs(lh)
          and abs(gc - gh) <= 1e-3 * abs(gh),
          "3m: the heads-on-model sharded step on the card is not the "
          "host's")


def phase_shard_train(dev, power: str, train_ms: float) -> dict:
    """Phase 3m: gemma3-1b at its published widths trained on a logical
    (2, 2, 2) ("pod", "data", "model") mesh of the card under
    ``arch_rules`` (head_dim, ff and vocab on the model axis, the attention
    core sequence-parallel; ZeRO-1 moments; the int8 pod hop): (a) step 0
    held to the unsharded step, (b) 3 timed steps, (c) one step from (b)'s
    state held to the unsharded step, (d) the heads-on-model layout at
    reduced widths against the host. Returns the launch counts
    of the port's kernels (none: no TPU kernel lies on this path)."""
    t_phase = time.perf_counter()
    _build.reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), remat=True)
    model = lm.init_params(0, cfg, device=dev)
    mesh = make_mesh(SHARD_SHAPE, SHARD_AXES, device=dev)
    rules = arch_rules(mesh, TRAIN_ARCH, TRAIN_EXTRA_RULES.get(TRAIN_ARCH))
    print(f"[3m] {cfg.name}: {lm.param_count(model):,} parameters, remat "
          f"on, on a logical {SHARD_SHAPE} {SHARD_AXES} mesh of the card; "
          f"rules: heads {rules.rules['heads']}, head_dim "
          f"{rules.rules['head_dim']}, ff {rules.rules['ff']}, vocab "
          f"{rules.rules['vocab']}, the core sequence-parallel over "
          f"{rules.rules['attn_core_seq_shard']}, batch "
          f"{rules.rules['batch']}")
    adamw = train_adamw()
    shard_held_step(model, train_batch(cfg, 0, dev), rules, adamw, power)
    torch.cuda.empty_cache()
    placed = shard_timed_steps(model, cfg, rules, adamw, power, train_ms)
    timed = {k: placed.pop(k) for k in ("step_ms", "collectives")}
    del model
    torch.cuda.empty_cache()
    shard_held_update(placed, cfg, rules, adamw,
                      train_batch(cfg, SHARD_STEPS, dev), power)
    torch.cuda.empty_cache()
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[3m] peak device memory {peak:.2f} GB (predicted "
          f"{SHARD_PREDICTED_PEAK_GB:.0f}); the port's kernels launched "
          f"{json.dumps(counts)}")
    check(peak < 80.0, f"3m: peak device memory {peak:.2f} GB")
    shard_heads_case(dev, power)
    print(f"[3m] phase in {time.perf_counter() - t_phase:.1f} s")
    return counts, timed


# -- phase 3n: the dry-run ---------------------------------------------------

DRY_SHAPE = "smoke_train"    # 3m's cell: 8 x 1024 tokens on its mesh
# the table of every cell on both production meshes: ``python -m
# repro_torch.launch.dryrun --all --mesh both --jobs 6 --summary`` (meta
# positions only: no card needed)
DRY_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs",
                         "dryrun_torch.json")
# the cell (c) traces again to hold the table to the code (seconds)
DRY_RECHECK = ("gemma3-1b", "decode_32k", False)
FCVI_SMOKE = dict(n=1 << 24, d=128, m=8, batch=1024, k=100, kprime=400)
FCVI_MESH = ((2, 4), ("data", "model"))
PEAK_WINDOW = (0.8, 1.25)    # the dry-run's whole-card peak / the card's
FCVI_TIE_RTOL, FCVI_TIE_ATOL = 1e-5, 1e-6
# predictions written in PERF.md before the first run: the train cell's
# whole-card peak over the card's, and each FCVI cell's ms
DRY_PREDICTED_PEAK_RATIO = 0.95
FCVI_PREDICTED_MS = {"base": 300.0, "bf16": 200.0}
# (d): the IVF layouts' cells on the same mesh, one layout for the three
FCVI_IVF = ("ivf8", "ivf8-trunc", "opt")
FCVI_IVF_PREDICTED_MS = {"ivf8": 150.0, "ivf8-trunc": 140.0, "opt": 130.0}


def placed_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree of placed tensors."""
    seen, total = set(), 0
    for p in dryrun.placed_leaves(tree):
        for t in p.blocks.flat:
            st = t.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
    return total


def colls_equal(a: dict, b: dict) -> bool:
    """Two collective records equal kind by kind: bytes, count, by axis."""
    norm = lambda r: {k: (int(v["bytes"]), int(v["count"]),  # noqa: E731
                          {x: int(y) for x, y in v["by_axis"].items()})
                      for k, v in r.items()}
    return norm(a) == norm(b)


def dry_train_cell(dev, power: str, shard: dict) -> None:
    """(a) The gemma3-1b train cell of 3m (8 x 1024 tokens on the logical
    (2, 2, 2) mesh, fp32 params as 3m's, ZeRO-1, the int8 pod hop) traced
    on meta positions, every group and layer, and run once for real on the
    card under ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode
    launch_specs.SHAPES[DRY_SHAPE] = dict(kind="train", seq=TRAIN_SEQ,
                                          batch=TRAIN_BATCH)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), remat=True)

    def build(mesh, device):
        return launch_specs.build_cell(
            cfg, TRAIN_ARCH, DRY_SHAPE, mesh, device=device,
            param_dtype=torch.float32)

    t0 = time.perf_counter()
    meta = make_mesh(SHARD_SHAPE, SHARD_AXES, device="meta")
    tr = dryrun.trace(lambda: build(meta, "meta"), meta, one_group=False)
    res = dryrun.cell_result(tr, meta)
    trace_s = time.perf_counter() - t0
    mesh = make_mesh(SHARD_SHAPE, SHARD_AXES, device=dev)
    cell = build(mesh, dev)
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - placed_bytes(cell.inputs)
    torch.cuda.reset_peak_memory_stats()
    stats = S.CollectiveStats()
    with FlopCounterMode(display=False) as fc:
        out = cell.run(stats)
    torch.cuda.synchronize()
    real_peak = torch.cuda.max_memory_allocated() - other
    flops = float(fc.get_total_flops())
    del out, cell
    torch.cuda.empty_cache()
    dry_flops = tr["exec"]["flops"] + tr["exec"]["conv_flops"]
    ratio = tr["exec"]["peak_bytes"] / real_peak
    bound_s = res["roofline"]["step_lower_bound_s"]
    step_s = shard["step_ms"] / 1e3
    mine = {k: v for k, v in stats.by_kind.items()}
    print(f"[3n] (a) {cfg.name} train cell, {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens on a logical {SHARD_SHAPE} mesh: traced in {trace_s:.1f} s"
          f" ({tr['ops']:,} ops); dot FLOPs executed {dry_flops:.6g} "
          f"(FlopCounterMode of the real step {flops:.6g}); collective bytes "
          f"{colls_str(tr['stats'].by_kind, 8)} (the real step's equal: "
          f"{colls_equal(tr['stats'].by_kind, mine)}; 3m's step's: "
          f"{colls_equal(tr['stats'].by_kind, shard['collectives'])}); "
          f"whole-card live peak {tr['exec']['peak_bytes'] / 1e9:.3f} GB "
          f"against max_memory_allocated {real_peak / 1e9:.3f} GB (ratio "
          f"{ratio:.3f}, predicted {DRY_PREDICTED_PEAK_RATIO}); per position "
          f"{res['per_device_flops']:.6g} FLOPs, "
          f"{res['per_device_bytes']:.6g} op-boundary bytes, peak "
          f"{res['memory']['peak_estimate_bytes'] / 1e9:.3f} GB, roofline "
          f"{res['roofline']['dominant']} {1e3 * bound_s:.3f} ms; 3m's step "
          f"{shard['step_ms']:.1f} ms >= 8 x {1e3 * bound_s:.3f} ms; card "
          f"{power}")
    check(dry_flops == flops, f"3n: the dry-run's dot FLOPs {dry_flops} "
          f"against the real step's {flops}")
    check(colls_equal(tr["stats"].by_kind, mine)
          and colls_equal(tr["stats"].by_kind, shard["collectives"]),
          "3n: the dry-run's collective bytes are not the real step's")
    check(PEAK_WINDOW[0] <= ratio <= PEAK_WINDOW[1], f"3n: the dry-run's "
          f"peak is {ratio:.3f} of max_memory_allocated")
    check(step_s >= 8 * bound_s, f"3n: the bound 8 x {bound_s} s exceeds "
          f"the measured step {step_s} s")


def exact_candidates(data: dict, variant: str, kprime: int):
    """The FCVI cell's search computed whole on the card: the exact L2
    top-(k' + 1) (scores, ids) of the transformed queries over every row,
    one fp32 product 64 queries at a time (the bf16 variant: the queries
    rounded to bf16 and the rows as stored, widened)."""
    from repro_torch.core.transform import psi_partition
    q_t = psi_partition(data["q"], data["fq"], 1.0)
    rows = data["corpus_t"]
    if variant == "bf16":
        q_t, rows = q_t.to(torch.bfloat16).float(), rows.float()
    vals, ids = [], []
    for lo in range(0, q_t.shape[0], 64):
        qc = q_t[lo:lo + 64]
        s = (2.0 * (qc @ rows.T) - data["sq_norms"][None]) - torch.sum(
            qc * qc, -1, keepdim=True)
        v, i = torch.topk(s, kprime + 1, dim=-1)
        vals.append(v), ids.append(i)
        del s
    return torch.cat(vals), torch.cat(ids)


def exact_rerank(data: dict, cand: torch.Tensor, k: int):
    """The cell's re-rank of ``cand`` computed whole: the lambda = 0.5
    cosine score of each candidate's row and filter, its top-(k + 1)."""
    q, fq = data["q"], data["fq"]

    def cos(c, v):
        return torch.sum(c * v[:, None], -1) / (
            torch.linalg.norm(c, dim=-1) * torch.linalg.norm(v, dim=-1)[
                :, None] + 1e-8)

    idx = cand.long()
    score = 0.5 * cos(data["vectors_n"][idx], q) + \
        0.5 * cos(data["filters_n"][idx], fq)
    vals, pos = torch.topk(score, k + 1, dim=-1)
    return vals, torch.gather(idx, -1, pos)


def dry_fcvi_cells(dev, power: str) -> dict:
    """(b) The FCVI base and bf16 cells at n = 2^24 on a logical (2, 4)
    mesh: traced on meta, then run for real on the card (B2 on each of the
    8 row blocks, the tree merge, the candidates' gather, the re-rank).
    The candidates equal the exact L2 top-k' outside near-ties, and the
    top-k the exact re-rank of those candidates outside near-ties."""
    counts: dict = {}
    shape, axes = FCVI_MESH
    k, kp = FCVI_SMOKE["k"], FCVI_SMOKE["kprime"]
    for variant in ("base", "bf16"):
        meta = make_mesh(shape, axes, device="meta")
        tr = dryrun.trace(lambda: launch_specs.build_fcvi_cell(
            FCVI_SMOKE, meta, variant=variant), meta)
        peak = PEAK_TF32_S if variant == "base" else PEAK_BF16_S
        res = dryrun.cell_result(tr, meta, peak)
        calls = sum(v["calls"] for v in tr["kernels"].values())
        mesh = make_mesh(shape, axes, device=dev)
        data = launch_specs.fcvi_inputs(FCVI_SMOKE, variant, dev, 7)
        cell = launch_specs.build_fcvi_cell(FCVI_SMOKE, mesh,
                                            variant=variant, data=data)
        cell.run(S.CollectiveStats())
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        vals, ids, cand = cell.run(S.CollectiveStats())
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launched = _build.launch_counts()
        add_counts(counts, launched)
        b2 = sum(v for name, v in launched.items()
                 if name.startswith(scan_mod.NAME))
        l2_v, l2_i = exact_candidates(data, variant, kp)
        c_agree, c_kept = ids_outside_ties(l2_v, l2_i, cand, L2_RTOL,
                                         L2_ATOL)
        rr_v, rr_i = exact_rerank(data, cand, k)
        agree, kept = ids_outside_ties(rr_v, rr_i, ids, FCVI_TIE_RTOL,
                                       FCVI_TIE_ATOL)
        bound = res["roofline"]["step_lower_bound_s"]
        print(f"[3n] (b) FCVI {variant}, n = {FCVI_SMOKE['n']:,}, d = "
              f"{FCVI_SMOKE['d']}, batch {FCVI_SMOKE['batch']}, k = {k}, "
              f"k' = {kp} on a logical {shape} mesh: {ms:.1f} ms (predicted "
              f"{FCVI_PREDICTED_MS[variant]:.0f}) >= 8 x the per-position "
              f"bound {1e3 * bound:.3f} ms ({res['roofline']['dominant']}; "
              f"{res['per_device_flops']:.4g} FLOPs, "
              f"{res['per_device_bytes']:.4g} bytes, "
              f"{res['per_device_collective_bytes']:.4g} collective bytes a "
              f"position); B2 launches {b2} ({json.dumps(launched)}), the "
              f"dry-run's score_topk calls {calls:g}; the k' candidates "
              f"equal the exact L2 top-k' in {c_agree} of {c_kept} slots "
              f"outside near-ties, the top-k the exact re-rank of them in "
              f"{agree} of {kept}; card {power}")
        check(b2 == calls, f"3n: FCVI {variant} launched B2 {b2} times, the "
              f"dry-run counts {calls}")
        check(c_agree == c_kept and c_kept > 0, f"3n: FCVI {variant}'s "
              f"candidates differ from the exact L2 top-k' in "
              f"{c_kept - c_agree} of {c_kept} slots")
        check(agree == kept and kept > 0, f"3n: FCVI {variant}'s ids differ "
              f"from the exact re-rank in {kept - agree} of {kept} slots")
        check(ms / 1e3 >= 8 * bound, f"3n: FCVI {variant}'s bound 8 x "
              f"{bound} s exceeds its {ms} ms")
        del cell, data, vals, ids, cand, l2_v, l2_i, rr_v, rr_i
        torch.cuda.empty_cache()
    return counts


def ivf_whole(data: dict, kprime: int):
    """The IVF cells' search computed whole on the card, block by block:
    the cell's own probe product (the same op on the same shapes, TF32
    off, so the same probes), every slot of the block's lists scored at
    once (the bf16 rows and the queries rounded to bf16, widened to fp32
    and multiplied on the tensor cores in TF32, which holds bf16 values
    exactly, 128 queries at a time), the probed lists' slots in probe
    order and their first k' + 1 (``topk_first``); the first k' over
    every list of the block (for the recall of the exhaustive search).
    Returns per block the probed (vals, ids) and the unprobed ones, global
    ids."""
    from repro_torch.core.transform import psi_partition
    q_t = psi_partition(data["q"], data["fq"], 1.0)
    q_b = q_t.to(torch.bfloat16).float()
    shards, nl, ls, _ = data["grouped"].shape
    every_probes = [ref.topk_first(q_t @ data["centroids"][s].T,
                                   launch_specs.NPROBE)[1]
                    for s in range(shards)]
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    probed, every = [], []
    try:
        for s, probes in enumerate(every_probes):
            rows = data["grouped"][s].reshape(nl * ls, -1).float()
            sq = data["grouped_sq"][s].reshape(-1)
            pv, pi, ev, ei = [], [], [], []
            for lo in range(0, q_b.shape[0], 128):
                sc = 2.0 * (q_b[lo:lo + 128] @ rows.T) - sq
                pr = probes[lo:lo + 128]
                pick = torch.gather(sc.view(-1, nl, ls), 1,
                                    pr[:, :, None].expand(-1, -1, ls))
                slot = pr[:, :, None] * ls + torch.arange(ls, device=sc.device)
                v, i = ref.topk_first(pick.reshape(pick.shape[0], -1),
                                      kprime + 1)
                pv.append(v)
                pi.append(torch.gather(slot.reshape(slot.shape[0], -1), 1, i))
                v, i = torch.topk(sc, kprime, dim=1)
                ev.append(v), ei.append(i)
                del sc, pick
            off = s * nl * ls
            probed.append((torch.cat(pv), torch.cat(pi) + off))
            every.append((torch.cat(ev), torch.cat(ei) + off))
            del rows
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep
    return probed, every


def ivf_stages(probed: list, mesh_shape, kl: int, kprime: int):
    """The cell's cuts on ``ivf_whole``'s block sets: each block's first
    ``kl``, the merge stages over the mesh (the last axis first) keeping
    ``kl`` but the last, which keeps k', padded (-inf, id 0) where its
    pool is smaller. Returns the candidates (b, k') and each cut's last
    kept and first dropped scores, (b, cuts, 2)."""
    bounds = []

    def cut(v, i, keep):
        if v.shape[1] > keep:
            bounds.append(v[:, keep - 1:keep + 1])
        return v[:, :keep], i[:, :keep]

    sets = [cut(v, i, kl) for v, i in probed]
    fan = list(reversed(mesh_shape))
    for j, n_ax in enumerate(fan):
        keep = kprime if j == len(fan) - 1 else kl
        nxt = []
        for g in range(0, len(sets), n_ax):
            v = torch.cat([x[0] for x in sets[g:g + n_ax]], 1)
            i = torch.cat([x[1] for x in sets[g:g + n_ax]], 1)
            if v.shape[1] < keep:
                pad = keep - v.shape[1]
                v = torch.cat([v, v.new_full((v.shape[0], pad),
                                             float("-inf"))], 1)
                i = torch.cat([i, i.new_zeros((i.shape[0], pad))], 1)
            top, pos = ref.topk_first(v, min(v.shape[1], keep + 1))
            nxt.append(cut(top, torch.gather(i, 1, pos), keep))
        sets = nxt
    return sets[0][1], torch.stack(bounds, 1)


def cand_check(data: dict, cand: torch.Tensor, want: torch.Tensor,
               bounds: torch.Tensor) -> tuple:
    """(queries whose candidates equal ``want``'s as multisets, queries
    differing only at near-ties, [queries differing elsewhere]): an id in
    one set and not the other is a near-tie where its score (the bf16
    rows and queries, fp32) lies within the L2 tolerance of a cut's last
    kept or first dropped score (``ivf_stages``' bounds)."""
    from repro_torch.core.transform import psi_partition
    a = torch.sort(cand.long(), 1).values
    w = torch.sort(want.long(), 1).values
    rows = torch.nonzero((a != w).any(1)).flatten().tolist()
    q_b = psi_partition(data["q"], data["fq"], 1.0).to(
        torch.bfloat16).float()
    flat = data["grouped"].reshape(-1, data["grouped"].shape[-1])
    sq = data["grouped_sq"].reshape(-1)
    ties, bad = 0, []
    for r in rows:
        got = collections.Counter(a[r].tolist())
        exp = collections.Counter(w[r].tolist())
        ids = torch.tensor(list((got - exp) + (exp - got)),
                           device=cand.device)
        sc = 2.0 * (flat[ids].float() @ q_b[r]) - sq[ids]
        edge = bounds[r].reshape(-1)
        edge = edge[torch.isfinite(edge)]
        gap = (sc[:, None] - edge[None, :]).abs().min(1).values
        if bool((gap <= L2_ATOL + L2_RTOL * sc.abs()).all()):
            ties += 1
        else:
            bad.append(r)
    return a.shape[0] - len(rows), ties, bad


def dry_fcvi_ivf_cells(dev, power: str) -> dict:
    """(d) The IVF layouts' cells (``ivf8``, ``ivf8-trunc``, ``opt``) at
    ``FCVI_SMOKE`` on ``FCVI_MESH``, over one layout (``fcvi_inputs``: 8
    blocks of 64 lists of 32,768 rows): traced on meta, then run for real
    (a warm run, then a timed one): B7 on each block, the merges, the
    re-rank. B7's launches equal the trace's calls; the candidates equal
    the search computed whole (``ivf_whole``, ``ivf_stages``) outside
    near-ties, pads included; the top-k equals the exact re-rank of the
    candidates; ``opt``'s top-k equals ``ivf8-trunc``'s; the time is at
    least 8 times the per-position bound. Prints B7 alone at the cell's
    shape beside its bound, and the recall@k of ``ivf8`` against the
    exhaustive search of every row (the same k', information only)."""
    counts: dict = {}
    shape, axes = FCVI_MESH
    k, kp = FCVI_SMOKE["k"], FCVI_SMOKE["kprime"]
    shards = int(np.prod(shape))
    t0 = time.perf_counter()
    data = launch_specs.fcvi_inputs(FCVI_SMOKE, "ivf8", dev, 7, shards)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    probed, every = ivf_whole(data, kp)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    print(f"[3n] (d) IVF layout of n = {FCVI_SMOKE['n']:,} rows over "
          f"{shards} blocks of {launch_specs.NLIST} lists of "
          f"{data['grouped'].shape[2]:,} rows made in {made_s:.1f} s; the "
          f"search computed whole in {whole_s:.1f} s")
    # B7 alone at the cell's shape: one block's slab, 1,024 queries
    from repro_torch.core.transform import psi_partition
    q_t = psi_partition(data["q"], data["fq"], 1.0)
    probes = ref.topk_first(q_t @ data["centroids"][0].T,
                            launch_specs.NPROBE)[1].to(torch.int32)
    valid = torch.ones(data["grouped_sq"][0].shape, device=dev)
    b7 = lambda: ops.ivf_score_topk_batch(  # noqa: E731
        data["grouped"][0], data["grouped_sq"][0], valid, probes,
        q_t.to(torch.bfloat16).float(), kp)
    plain = lambda k_: ref.ref_ivf_score_topk_batch(  # noqa: E731
        data["grouped"][0], data["grouped_sq"][0], valid, probes,
        q_t.to(torch.bfloat16).float(), k_)
    got, want = b7(), plain(kp + 1)
    wv = want[0][:, :kp]
    tol_all = L2_ATOL + L2_RTOL * wv.abs()
    err = (got[0] - wv).abs().max().item()
    within = bool(((got[0] - wv).abs() <= tol_all).all())
    agree, total = ids_outside_ties(want[0], want[1], got[1], L2_RTOL,
                                    L2_ATOL)
    del got, want, wv, tol_all
    b7_ms = time_ms(b7, iters=5, warmup=1)
    plain_ms = time_ms(lambda: plain(kp), iters=1, warmup=0)
    b, npr, nl, ls, d = (q_t.shape[0], launch_specs.NPROBE,
                         *data["grouped"].shape[1:])
    lists = min(nl, b * npr)
    nbytes = lists * ls * (2 * d + 8) + b * npr * 4 + b * d * 4 + b * kp * 8
    b7_bound, b7_by = bound_ms(nbytes, 2.0 * b * npr * ls * d,
                               op_peak(data["grouped"].dtype))
    print(f"[kernel] ivf_score_topk_batch_bf16 at the IVF cell's shape (b = "
          f"{b}, nprobe = {npr}, {nl} lists of {ls:,}, d = {d}, k' = {kp}): "
          f"max_abs_err {err:.3g} against the plain version, ids "
          f"{agree}/{total} outside near-ties; {b7_ms:.3f} ms (plain "
          f"{plain_ms:.1f} ms) against the bound {b7_bound:.3f} ms ({b7_by}:"
          f" {nbytes / 1e9:.3f} GB, the slab once, "
          f"{2.0 * b * npr * ls * d:.4g} FLOPs on bf16 operands at "
          f"{PEAK_BF16_S / 1e12:.0f} TFLOP/s); each (query, probe) "
          f"reads a {ls * d * 2 / 1e6:.1f} MB list, "
          f"{b * npr * ls * d * 2 / 1e9:.1f} GB where the cache keeps none; "
          f"card {power}")
    check(within and agree == total and total > 0,
          f"3n: B7 at the IVF cell's shape: error {err} or {total - agree} "
          "ids outside near-ties against its plain version")
    del valid, probes
    tops = {}
    for variant in FCVI_IVF:
        meta = make_mesh(shape, axes, device="meta")
        tr = dryrun.trace(lambda: launch_specs.build_fcvi_cell(
            FCVI_SMOKE, meta, variant=variant), meta)
        res = dryrun.cell_result(tr, meta, PEAK_BF16_S)
        calls = tr["kernels"][ivf_kern.NAME_BATCH]["calls"]
        mesh = make_mesh(shape, axes, device=dev)
        cell = launch_specs.build_fcvi_cell(FCVI_SMOKE, mesh,
                                            variant=variant, data=data)
        cell.run(S.CollectiveStats())
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        vals, ids, cand = cell.run(S.CollectiveStats())
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launched = _build.launch_counts()
        add_counts(counts, launched)
        n_b7 = launched.get(ivf_kern.NAME_BATCH + "_bf16", 0)
        kl = (launch_specs.K_LOCAL if variant != "ivf8" else kp)
        want, bounds = ivf_stages(probed, shape, kl, kp)
        same, ties, bad = cand_check(data, cand, want, bounds)
        pads = int((cand == 0).sum(1).max())
        rr_v, rr_i = exact_rerank(data, cand, k)
        agree, kept = ids_outside_ties(rr_v, rr_i, ids, FCVI_TIE_RTOL,
                                       FCVI_TIE_ATOL)
        tops[variant] = (rr_v, ids)
        bound = res["roofline"]["step_lower_bound_s"]
        print(f"[3n] (d) FCVI {variant}, n = {FCVI_SMOKE['n']:,}, batch "
              f"{FCVI_SMOKE['batch']}, k = {k}, k' = {kp} on a logical "
              f"{shape} mesh: {ms:.1f} ms (predicted "
              f"{FCVI_IVF_PREDICTED_MS[variant]:.0f}) >= 8 x the "
              f"per-position bound {1e3 * bound:.3f} ms "
              f"({res['roofline']['dominant']}; {res['per_device_flops']:.4g}"
              f" FLOPs, {res['per_device_bytes']:.4g} bytes, "
              f"{res['per_device_collective_bytes']:.4g} collective bytes a "
              f"position); B7 launches {n_b7} ({json.dumps(launched)}), the "
              f"dry-run's calls {calls:g}; the k' candidates equal the "
              f"search computed whole for {same} of {cand.shape[0]} queries "
              f"and differ only at near-ties of a cut for {ties} (elsewhere "
              f"{len(bad)}; up to {pads} pads a query), the top-k the exact "
              f"re-rank of them in {agree} of {kept}; card {power}")
        check(n_b7 == calls == shards, f"3n: FCVI {variant} launched B7 "
              f"{n_b7} times, the dry-run counts {calls}")
        check(not bad and same > 0, f"3n: FCVI {variant}'s candidates "
              f"differ from the search computed whole outside near-ties "
              f"for queries {bad[:8]}")
        check(agree == kept and kept > 0, f"3n: FCVI {variant}'s ids differ "
              f"from the exact re-rank in {kept - agree} of {kept} slots")
        check(ms / 1e3 >= 8 * bound, f"3n: FCVI {variant}'s bound 8 x "
              f"{bound} s exceeds its {ms} ms")
        if variant == "ivf8":
            ev = torch.cat([v for v, _ in every], 1)
            ei = torch.cat([i for _, i in every], 1)
            top, pos = torch.topk(ev, kp, dim=1)
            _, flat_ids = exact_rerank(data, torch.gather(ei, 1, pos), k)
            hit = (ids.long()[:, :, None] == flat_ids[:, None, :k]).any(-1)
            print(f"[3n] (d) recall@{k} of ivf8 against the exhaustive "
                  f"search of every row (the same k' and re-rank): "
                  f"{hit.float().mean().item():.4f}")
            del ev, ei, top, pos, flat_ids
        del cell, vals, cand, want, bounds, rr_i
        torch.cuda.empty_cache()
    agree, kept = ids_outside_ties(*tops["ivf8-trunc"], tops["opt"][1],
                                   FCVI_TIE_RTOL, FCVI_TIE_ATOL)
    print(f"[3n] (d) opt's top-k equals ivf8-trunc's in {agree} of {kept} "
          f"slots outside near-ties")
    check(agree == kept and kept > 0, f"3n: opt's top-k differs from "
          f"ivf8-trunc's in {kept - agree} of {kept} slots")
    del data, probed, every, tops
    torch.cuda.empty_cache()
    return counts


def print_table(path: str) -> None:
    """(c) The dry-run of every cell on both production meshes, as
    ``launch.dryrun --all --mesh both --summary`` wrote it (meta
    positions only: no card needed): each cell's busiest
    position's live peak against the card's 80 GB, the dominant roofline
    term and the bound. Every cell of the current lists must be there,
    ok or skipped, and ``DRY_RECHECK``'s cell traced again must equal its
    row."""
    with open(path) as fh:
        results = json.load(fh)
    print(f"[3n] (c) the dry-run of every cell on both production meshes "
          f"({os.path.relpath(path)}: meta positions, per position; the "
          f"roofline of {results[0].get('card', '?')}, links NVLink inside "
          f"a node of 8, InfiniBand across):")
    for line in dryrun.table(results).splitlines():
        print("[3n]   " + line)
    want = {(a, sh, m) for a in list_archs() for sh in launch_specs.SHAPES
            if sh != DRY_SHAPE for m in ("pod16x16", "pod2x16x16")}
    want |= {("fcvi", sh + tag, m) for sh in launch_specs.FCVI_SHAPES
             for tag in [""] + ["_" + name for name, v in
                                dryrun.VARIANTS.items() if v["arch"] == "fcvi"]
             for m in ("pod16x16", "pod2x16x16")}
    have = {(r["arch"], r["shape"], r["mesh"]) for r in results}
    ok = [r for r in results if r.get("status") in ("ok", "skipped")]
    check(have == want and len(ok) == len(results), f"3n: the dry-run "
          f"table {path} lacks {sorted(want - have)} or has cells not ok: "
          f"{[r['arch'] for r in results if r not in ok]}")
    # one cheap cell traced again: the table is the current code's
    arch, shape, multi = DRY_RECHECK
    t0 = time.perf_counter()
    again = dryrun.run_cell(arch, shape, multi, verbose=False)
    row = next(r for r in results if (r["arch"], r["shape"], r["mesh"])
               == (arch, shape, again["mesh"]))
    keys = ("per_device_flops", "per_device_bytes",
            "per_device_collective_bytes", "useful_flops_fraction")
    same = all(again[k] == row[k] for k in keys) and (
        again["memory"]["peak_estimate_bytes"]
        == row["memory"]["peak_estimate_bytes"])
    print(f"[3n] (c) {arch} {shape} {again['mesh']} traced again in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{', '.join(f'{k} {again[k]!r}' for k in keys)}, peak "
          f"{again['memory']['peak_estimate_bytes']!r}; the table's row "
          f"equal: {same}")
    check(same, f"3n: {arch} {shape} traced again differs from its row in "
          f"{path}: the table is stale")


def phase_dryrun(dev, power: str, shard: dict) -> dict:
    """Phase 3n: the dry-run held to the card. Returns B2's and B7's
    launches."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    dry_train_cell(dev, power, shard)
    counts = dry_fcvi_cells(dev, power)
    add_counts(counts, dry_fcvi_ivf_cells(dev, power))
    print_table(DRY_TABLE)
    print(f"[3n] phase in {time.perf_counter() - t_phase:.1f} s")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    power = card()
    print(f"[card] {power}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}")
    phase_build()
    res = phase_kernels(dev, torch.Generator(device=dev).manual_seed(0),
                        power)
    inp = make_inputs()
    counts, recall, flat_ids, flat_ix = phase_end_to_end(dev, power, inp)
    phases = {"3": dict(counts)}
    torch.cuda.empty_cache()
    ivf_res, ivf_counts, ivf_recall, ivf_ix = phase_ivf(dev, power, inp,
                                                        recall)
    torch.cuda.empty_cache()
    pq_res, pq_counts, pq_ix = phase_pq(dev, power, inp, recall, ivf_recall)
    torch.cuda.empty_cache()
    sf_res, sf_counts, built = phase_storage_flat(dev, power, inp, flat_ids)
    si_res, si_counts, ivf_built = phase_storage_ivf(dev, power, inp,
                                                     ivf_recall)
    torch.cuda.empty_cache()
    pf_res, pf_counts = phase_predicates(dev, power, inp, dict(
        flat=flat_ix, ivf=ivf_ix, **built, **ivf_built))
    bf16_ix = built["flat-bf16"]
    del built, ivf_built
    torch.cuda.empty_cache()
    sg_res, sg_counts = phase_shapes(dev, power, inp, flat_ix, ivf_ix, pq_ix)
    torch.cuda.empty_cache()
    lc_counts = phase_lifecycle(dev, power, inp, flat_ix, bf16_ix)
    torch.cuda.empty_cache()
    sh_counts = phase_sharded(dev, power, inp, {
        "flat": flat_ix, "flat-bf16": bf16_ix, "ivf": ivf_ix, "pq": pq_ix})
    del flat_ix, bf16_ix, ivf_ix, pq_ix
    torch.cuda.empty_cache()
    lm_counts = phase_lm(dev, power)
    torch.cuda.empty_cache()
    lmk_counts = phase_lm_families(dev, power)
    torch.cuda.empty_cache()
    train_counts, train_ms = phase_train(dev, power)
    torch.cuda.empty_cache()
    shard_counts, shard_timed = phase_shard_train(dev, power, train_ms)
    torch.cuda.empty_cache()
    dry_counts = phase_dryrun(dev, power, shard_timed)
    for tag, r, c in (("3b", ivf_res, ivf_counts), ("3c", pq_res, pq_counts),
                      ("3d", sf_res, sf_counts), ("3e", si_res, si_counts),
                      ("3f", pf_res, pf_counts), ("3g", sg_res, sg_counts),
                      ("3h", {}, lc_counts), ("3i", {}, sh_counts),
                      ("3j", {}, lm_counts), ("3k", {}, lmk_counts),
                      ("3l", {}, train_counts), ("3m", {}, shard_counts),
                      ("3n", {}, dry_counts)):
        phases[tag] = dict(c)
        res.update(r)
        for name, n in c.items():
            counts[name] = counts.get(name, 0) + n
    check(counts.get(rescore_kern.NAME_WIDE, 0) == 0,
          "a serving path re-ranked past the fused re-rank's capacity")
    print("[counts] launches by phase: "
          + json.dumps({name: [phases[p].get(name, 0) for p in phases]
                        for name in SOURCES}))
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        launches = counts.get(name, 0)
        check(launches > 0, f"kernel {name} was not launched on the main "
              "paths (phases 3 and 3b to 3n)")
        r = res[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches,
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"],
                            device_ms=r.get("device_ms")))
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
