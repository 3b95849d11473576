#!/usr/bin/env python3
"""Smoke test of vectorian_tpu_torch on one NVIDIA card (an H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure:

1. Device: a CUDA card must be present; prints its name and power limit.
2. Build: compiles every kernel of the port from the checkout's sources
   (csrc/*.cu, one nvcc per source, all started together; prints each
   ptxas report) and the native host library (csrc/vectorian_native.cpp,
   the traceback and fastText encoder).  Fails if an affine template up
   to T1P = 33 (gather at f32, bf16 and int8 tables, row-gather, and the
   tagged f32 family of both entries), a kernel of either affine wide
   route (the register-resident one at 4, 8 and 16 columns a lane) or any
   kernel of the WSB register route (gather at each table type,
   row-gather, tagged or not) or of its long route (gather at each table
   type, row-gather, dense) or of its wide route (the same entries, 2, 4,
   8 and 16 slots a lane) has a stack frame or spills; prints the T1P = 65
   templates' reports and the wide_regs ones on lines of their own.
3. Kernels against their plain torch versions on the card (random tables,
   tokens and costs from a seeded generator), bit for bit (torch.equal):
   the affine corpus kernel, the WSB corpus kernel (the register route at
   every bucket capacity and needle width it takes, Q 1, 3 and 32; the
   one-thread-a-problem routes, shared-memory rows and scratch, at their
   shapes), the row-gather entries of the score-only rescore (B 700, 8,192
   and 65,536 problems, L 16 and 32, T 8 and 16, 1 and 12 query slots,
   plus L=64 and L=256 buckets; every route), each timed against the
   gather + flat-batch form it replaces and against its bound, and the
   flat-batch wrappers, each in 3 localities and 2 affine gap sets or 3
   general gap models.  3b: both corpus kernels on bf16 and int8 ranking
   tables (ops/search.stack_query_tables, costs in the table's units):
   affine_dp at L {16, 32} x Tpad {8, 16} x Q {1, 32}, L 16 x Tpad 32, 64
   at Q 32 and Tpad 12 at Q 3 (padded to whole 8-column chunks), wsb_dp's
   register route at the same shapes plus one shared-rows and one scratch
   shape, bit for bit, each timed against the f32 kernel on the table
   before quantizing (in turns); a float16 table must raise.  Then
   ``quant_turns``: each quantized launch's device time in turns against
   its f32 self (and, with ``--old-tree``, the parent's kernel) at the main
   path's shape, a find's Q 1, Tpad 16 / 32 / 64 and kernel 1's wide_regs
   at Tpad 132, beside its bound.  Wide routes: the
   affine gather (f32, bf16, int8, tagged), rows (f32, tagged) and dense
   entries at needles padded to 132 and 256 on the register-resident wide
   route (wide_regs), against their plain versions bit for bit and timed
   in turns against the shared-memory wide route on the same inputs, the
   gather's default call (split by needle width) beside them, each against
   its bound; the shared-memory route where the plan
   keeps it (1,024; 2,048, past shared memory: the scratch route); the
   register templates against wide_regs at Tpad 64, wide_regs at 128.
   3 (long buckets): kernel 3's long route at bucket capacities 64, 128
   and 256 x needles padded to 8, 16 and 32 x Q 1, 3 and 32 (f32, bf16
   and int8 gather tables, the row-gather and dense entries, 3
   localities, ExponentialGapCost(3.0) and a CustomGapCost) bit for bit,
   each launch timed in turns against the old thread-a-problem body
   forced (shared / scratch) beside its bound; the shapes the old body
   still serves (buckets of 512 and 1,024, a needle of 256 columns past
   the wide route's shared memory, a gap bonus, a tagged launch) held and
   timed once.
   3 (wide needles): kernel 3's wide route at bucket capacities 8, 16 and
   64 x needles padded to 40, 64, 136, 256 and 512 (where its shared
   memory holds the bucket) x Q 1, 3 and 32 (f32, bf16 and int8 gather
   tables, forced and split by needle, 3 localities,
   ExponentialGapCost(3.0) and a concave CustomGapCost), the row-gather
   entry and the dense entry at 4f's chunk, bit for bit, each launch timed
   in turns against the old body forced beside its bound.
   3t: the tagged entries
   (the tag-weighted block, dp_kernels.TagBlock) of kernels 1-3 on every
   route — affine registers at T1P 9 / 17 / 33 / 65 and Q = 1 (float4
   rows), wide shared and scratch; affine row-gather registers and wide;
   WSB registers (groups of 8, 16, 32 lanes, one and two queries a
   group), shared, scratch and the L=256 bucket; WSB row-gather
   registers, shared (a gap bonus) and scratch — in 3 localities, bit for
   bit, each timed against its untagged self in turns and its bound.
   3d: the dense entries of kernels 1 and 3 (the [c, L, Tpad, Q] block a
   contextual chunk's metric GEMM writes) at the contextual pass's chunk
   of L 16 / 8 / 16 / 32 against Tpad 8 / 8 / 16 / 32, each at Q 32 and
   Q 1 (every route the dense plans take there, forced, each timed on the
   device in turns against the old design), at Tpad 132 and (WSB) L 64,
   in 3 localities, bit for bit, timed against their plain versions and
   bounds; then the affine plan's two routes in turns at the problem
   counts its threshold is read at, on bucket 16's length mix.
4. Main path at real size: a 1,000,000-sentence Zipf corpus (9 tokens a
   sentence over 5,000 words, a 5,000 x 300 KeyedVectors), Session(device=
   "cuda") -> partition("sentence") -> index; find_batch of 32 queries at
   the default ranking precision (int8), "bfloat16" and "float32", and 21
   find() calls, under an affine index (4) and, on the same packing, under
   LocalAlignment(ExponentialGapCost(3.0)) (4b).  The launch counts are set
   to 0 right before each and read right after; the three precisions and
   find must be byte-identical, and every WSB launch of 4b must take the
   register route.  Per precision: wall time, alignments/s, extras rounds,
   row-gather launches and the wait for the int8/bf16 scale read.  At the
   main path's shapes (Q=32 at each table type, and the Q=1 of a find)
   each corpus kernel is held against its plain version and timed; the
   WSB register route against the one-thread-a-problem route in turns
   (new, old, old, new).  4c: a small corpus of repeated
   sentences whose ties make every cut unsafe, so the finalizer's extras
   round runs the row-gather kernels (affine and general index; one launch
   a bucket a round), held against the port on the CPU; prints the
   launches a round and the round's device ms against the per-column
   gather + flat-batch form it replaced.
   4 (long queries): on the same packing, an affine find of a 160-token
   query and a find_batch of 32 queries that holds it (every needle
   padded to 160) at each precision, byte-identical; the batch's pass
   splits by needle width, so its 31 short needles take the register
   route and the long one wide_regs (as the find does); the whole batch's
   call and the long needle's launch held against their plain versions
   at those shapes and timed with their bounds, the launch in turns
   against the shared-memory wide route.
   4 (long queries, general gaps): the same 160-token find and batch
   under LocalAlignment(ExponentialGapCost(3.0)) at each precision,
   byte-identical; the batch's short needles must take the register route
   and the long one kernel 3's wide route (as the find does), no
   thread-a-problem launch; the find's p50, a profile of the int8 and f32
   batches; at the path's shapes each group's launch held against its
   plain version on 65,536 slices a bucket, timed there in turns against
   the old body, and on the whole packing beside its bound.
   4d: BASELINE config 1, fastText 300d (a .bin with cc.en.300.bin's
   arguments, dim 300, n-grams of 5, 2,000,000 buckets, its dictionary the
   corpus's 2,500 most frequent words, written from the seed into a
   temporary directory) added to phase 4's session, LocalAlignment with
   affine gaps, each query holding 2 words outside the corpus: .bin write
   and load, vocabulary encode, find p50 and find_batch Q=32, byte-identical.
   Then index.warmup() (and a first find: no compiler may run) and the
   packed-corpus cache cold (pack and save) against a hit (load), under a
   VECTORIAN_CACHE_HOME of the run's own, with the same matches.  4c also
   runs a 135-token query whose extras round takes the row-gather entry's
   wide route, and an index with tag weights, whose extras rounds run the
   tagged row-gather kernels (affine and general gaps).
   4e: the query options on phase 4's session, under the affine and the
   general-gap index: find_batch of the 32 queries and the 21 finds under
   tag weights (f32), token_filter + pos_filter and a
   Saliency(KeywordSignal) booster at int8, bf16 and f32, and
   bidirectional; find and every precision byte-identical; wall time,
   alignments/s, extras rounds, Saliency.compile's time; the tagged corpus
   kernels held against their plain versions at the tagged pass's shapes
   (Q = 32 and a find's Q = 1) and timed against their untagged selves.
   4g, on phase 4's session: submatch_weight=0.5 through find (p50 of 21)
   and find_batch Q=32, affine and general gaps, byte-identical; a find
   with a debug callback counting its hooks; a boosted submatch find.
   4f: contextual search: 125,000 of phase 4's sentences and a d=256
   LambdaContextualEmbedding (seeded word vectors plus 0.2 of each
   neighbour's): ensure_contextual's packing, find p50 (21) and
   find_batch Q=32 under affine and general gaps, byte-identical, each
   dense kernel held against its plain version at the pass's shapes, a
   torch.profiler trace of one find_batch; the card against the CPU on a
   3,000-sentence cut of the corpus.
   4k: the transport find_batch on phase 4's session (WordMoversDistance()
   relaxed, relaxed=False and WordRotatorsDistance(), Q=32 of 7 tokens):
   wall ms, alignments/s, the ranking pass's device ms, host spans,
   consume rounds, exact solves and fused-fetch pairs a batch, an untimed
   loop of find over the 32 queries = the batch's bytes; on the
   3,000-sentence cut the card against the CPU, find = find_batch bytes and
   full WMD / WRD = the exhaustive oracle; after 4h one relaxed-WMD batch of
   the mixed tree, = a loop of find's bytes.  4l: paged serving (Session(paged=True)'s engine) over
   phase 4's packing (affine and general find p50 and find_batch at int8, a
   relaxed-WMD batch), 4c's tie-heavy corpus (extras rounds re-page
   buckets) and 4f's packing and store (pinned host bf16): paged = resident
   byte for byte, peak device memory and host -> device bytes a pass, a
   torch.profiler split of the copies under kernels, each kernel's first
   launch on a paged bucket bit for bit against its plain version.
   4m: multi-device serving over a mesh of four shards on the card
   (``make_mesh(["cuda:0"] * 4)``; ``make_mesh()``'s device count printed
   first): on phase 4's session find_batch Q=32 at int8, bf16 and f32
   under the affine and the general index, 4e's tag weights under both,
   and 21 find(mesh=); 4k's relaxed, full WMD and WRD batches; 4f's
   contextual batch (affine and general) and 4h's tree batch; each
   byte-identical to the same call without a mesh (4k's own last batch
   for the transport metrics), its launch counts set to 0 right before
   and read right after, then its wall beside its twin's (in turns: mesh,
   single, single, mesh; the transport batches only under
   ``--mesh-check``), the merge's host time; kernels 1 and 3 on one
   shard's inputs (each table type, tagged, dense) bit for bit against
   their plain versions, the four shards' launches timed against the
   bucket's one launch.
   4r (after 4n): a length-mixed corpus, 125,000 sentences of log-normal
   lengths (median 18 tokens, sigma 0.55, 3-250) over phase 4's
   vocabulary and vectors, LocalAlignment(ExponentialGapCost(3.0)):
   find_batch Q=32 at each precision and 21 finds as in 4b, byte-identical,
   every bucket up to 32 tokens on the register route and every one of
   64-256 on the long route; a find_batch of 32 prose-length queries
   (4r's length law; at least one past 32 tokens) at each precision, its
   pass split by needle width as planned (the wide route on the path),
   byte-identical to its finds; per bucket the kernel against its plain
   version on the path's tables, its device ms in one pass, the long
   buckets in turns against the old body.
   4n: the storage and notebook layer.  On phase 4's session,
   ``Result.format("excerpt +tags +metric, flow, matrix")._repr_html_()``
   of the 21 affine ``find`` results, of one int8 ``find_batch`` of the 32
   queries under the affine and the ``ExponentialGapCost(3.0)`` index, and
   of 21 relaxed-WMD ``find`` results (sparse flows): per result one
   excerpt and one flow box a match, the flow SVG's paths = the match's
   flow edges, one matrix spec a match, each match's slice text in its
   excerpt; host ms a result (p50, max).  A ``LabSession`` over the
   3,000-sentence cut: ``run_query`` = the plain ``Session``'s lists byte
   for byte, kernel 1 launched.  Where ipywidgets is installed,
   ``InteractiveQuery`` on the cut's card session: ``run`` under an affine
   and a general-gap configuration = the index's ``find`` byte for byte
   (kernel 1, then kernel 3, launched), ``QueryWidget.search_html()``.
   After phase 4's session is dropped, where h5py is installed: a
   ``TemporaryCorpus`` of phase 4's first CORPUS_SENTENCES sentences, a
   cold ``Session(corpus)`` (prepare, store the flavor, pack) and a
   second session over ``Corpus(path)`` (the flavor hit: no
   ``prepare_document`` call), ``find`` p50 (21) and an int8
   ``find_batch`` Q=32 on both, byte-identical; the add, cold and reopen
   seconds beside phase 4's host build.  A part whose package (h5py,
   ipywidgets) is not installed does not run: a line names it and why;
   with holoviews installed the flow renders take its branch and the SVG
   path count is not checked (a line says so).
5. The port on the card against the port on the CPU on a small corpus,
   affine and general-gap indexes, phase 4's long query, and 4e's
   options at each of their precisions.

``--old-tree DIR`` (with the full run, ``--tag-check`` or
``--quant-check``) loads the dp_kernels module of the checkout in DIR (a
``git archive`` of the parent commit) beside this one, builds its kernels
from DIR's sources, and times every tagged launch of phases 3t, 4e and 4c,
and its untagged self, in turns against that tree's (``tag_turns``), and
every quantized launch of 3b's ``quant_turns``.

``python3 chip_smoke.py --build-ab`` instead times phase 2's build with and
without ``--split-compile 0`` and exits; ``--quant-check [SASS_DIR]`` runs
phase 2, the quantized register templates' ptxas reports and SASS
instruction mix beside their f32 selves (both trees with ``--old-tree``),
phase 3b and phases 4 / 4b alone; ``--long-check`` runs phase 2, phase
3's long-bucket shapes with every gap model on every table, the old body's
shared / scratch crossover (``wsb_shared_crossover``) and 4r alone;
``--wide-general-check`` runs phase 2, phase 3's wide general-gap shapes
with every gap model on every table, the old body's shapes, the general
long query (phase 4's session) and 4r's prose-length batch alone;
``--dense-check`` runs phases 2,
3d and 4f alone; ``--wide-check`` phase 2, phase 3's wide cases and the
long-query phase (on phase 4's session); ``--mesh-check`` phase 2, 4k
and 4m; ``--notebook-check`` phase 2 and 4n on the 3,000-sentence cut
(its renders, LabSession and InteractiveQuery, and a stored corpus of the
cut's sentences).  ``--transport-reps N`` (with any of them) times 4k's static
batches N times a metric instead of once.  ``python3 chip_smoke.py
--tag-check [SASS_DIR]`` runs phase 2, phase 3t and phase 3's general-gap
kernels alone, both tagged corpus kernels at 4e's shapes
(``tag_path_shapes``), the tagged register templates of both kernels beside
their untagged selves (``register_templates``: ptxas report, SASS
instruction mix and innermost loops), then the WSB shared / scratch
route's untagged and tagged templates side by side (also their times in
both turn orders; ``phase_tag_check``) and exits.

Prints one JSON line per phase, the card's name and power limit, the
kernels' line ({"kernels": [...]}) and, last, {"ok": true, "device": ...}.
torch.profiler traces of one find_batch at int8 and at f32 and one find per
main path report the device busy time, idle share and top kernels.
"""

import concurrent.futures
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# HBM rate of an H100 SXM (NVIDIA data sheet, at the 700 W power limit)
PEAK_BYTES = 3.35e12
# The DP's f32 work is adds, subtracts and maxes, one instruction each and
# no FMA.  The data sheet's 67 TFLOP/s counts an FMA as two operations, so
# the card issues at most half of that in single f32 instructions: SMs x 128
# f32 lanes x the SM clock (~33.5e12/s at 132 SMs and 1.98 GHz).  Phase 1
# reads the SM count and the clock (nvidia-smi clocks.max.sm) from the card.
F32_LANES_PER_SM = 128
F32_INSTR_RATE = None
SM_HZ = None  # the SM clock (phase 1), for the sleep of ``device_ms``
SEED = 0
DEVICE = "cuda"
# the parent's dp_kernels module (``--old-tree DIR``, a ``git archive`` of the
# parent commit), built from that tree's sources: the old design that phases
# 3t, 4e and 4c time in turns against this one; None: no such comparison
OLD = None
SENTENCES = 1_000_000  # the bench.py e2e corpus size
# phase 3 sizes of the general-gap kernels: problems a corpus-pass shape,
# slices of the long (scratch-route) bucket, and flat batch size — the
# plain versions finish in seconds on the card at these
AFFINE_N = 65_536
WSB_PROBLEMS = 65_536
WSB_REG_PROBLEMS = 16_384
WSB_LONG_SLICES = 256
FLAT_B = 65_536
# phase 3 row-gather cases: problems a launch, and the bucket rows they index
ROWS_BATCHES = (700, 8_192, 65_536)
ROWS_BUCKET = 65_536
# phase 3's wide-route shapes: slices a gather case and problems a
# row-gather case (the plain version gathers an [n, L, Tpad, Q] f32 block:
# 8.6 GB at n = 8,192, L = 32, Tpad = 256, Q = 32)
WIDE_N = 8_192
WIDE_B = 8_192
LOCALITIES = ("local", "global", "semiglobal")
# find_batch's ranking precisions (None: the default, int8) and the
# quantized table types, with their tags in the kernels' launch counts
PRECISIONS = (None, "bfloat16", "float32")
# 4k's timed static transport batches a metric (``--transport-reps N``; one,
# so that 4m's mesh batches fit the run's time)
TRANSPORT_REPS = 1
QUANT_TAGS = {"bfloat16": "bf16", "int8": "int8"}


def log(msg):
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


def _smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device():
    global F32_INSTR_RATE, SM_HZ
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    card = _smi("name,power.limit")
    print(card, flush=True)
    mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    SM_HZ = mhz * 1e6
    F32_INSTR_RATE = sms * F32_LANES_PER_SM * SM_HZ
    emit({"phase": "device", "card": card, "sms": sms, "max_sm_mhz": mhz,
          "f32_instructions_per_s": F32_INSTR_RATE})
    return card


# the table's element type, last template argument: float, unsigned short
# (bf16 bits), signed char (int8)
_ELEM = {"f": "f32", "t": "bf16", "a": "int8"}
_AFFINE_TEMPLATE = re.compile(
    r"affine_dp_kernel(?:_4b)?ILi(\d+)ELi(\d)ELb([01])ELb([01])E([fta])E")
_WSB_REGS_TEMPLATE = re.compile(
    r"wsb_regs_kernelILi(\d+)ELi(\d+)ELi(\d)ELi(\d)ELb([01])E([fta])E")
_WSB_REGS_PAIRED = re.compile(r"wsb_regs_paired_kernelILi(\d+)ELi(\d+)ELi(\d)E([ta])E")
_AFFINE_WIDE_TEMPLATE = re.compile(
    r"affine_dp_wide_kernelILi(\d)ELb([01])ELb([01])E([fta])E")
# the tagged (f32) families: the same template arguments without the type
_AFFINE_TAGGED = re.compile(
    r"affine_dp_tagged_kernel(?:_4b|_6b)?ILi(\d+)ELi(\d)ELb([01])ELb([01])EE")
_AFFINE_WIDE_TAGGED = re.compile(r"affine_dp_wide_tagged_kernelILi(\d)ELb([01])ELb([01])EE")
_WSB_REGS_TAGGED = re.compile(
    r"wsb_regs_tagged_kernelILi(\d+)ELi(\d+)ELi(\d)ELi(\d)ELb([01])EE")
# the dense-block (K3) families
_AFFINE_DENSE = re.compile(r"affine_dp_dense_kernelILi(\d+)ELi(\d)ELb([01])EE")
_AFFINE_WIDE_DENSE = re.compile(r"affine_dp_wide_dense_kernelILi(\d)ELb([01])EE")
# the register-resident wide route (CPL: DP columns a lane)
_AFFINE_WIDE_REGS = re.compile(r"affine_dp_wide_regs_kernelILi(\d+)ELi(\d)ELb([01])E([fta])E")
_AFFINE_WIDE_REGS_TAGGED = re.compile(
    r"affine_dp_wide_regs_tagged_kernelILi(\d+)ELi(\d)ELb([01])EE")
_AFFINE_WIDE_REGS_DENSE = re.compile(r"affine_dp_wide_regs_dense_kernelILi(\d+)ELi(\d)EE")
_WSB_REGS_DENSE = re.compile(r"wsb_regs_dense_kernelILi(\d+)ELi(\d+)ELi(\d)ELi(\d)EE")
_WSB_DENSE = re.compile(r"wsb_dp_dense_kernelILi(\d)ELi(\d+)EE")
# kernel 3's long route (G, rows, type; the dense family; the locality is
# a kernel argument)
_WSB_LONG = re.compile(r"wsb_long_kernelILi(\d+)ELb([01])E([fta])E")
_WSB_LONG_DENSE = re.compile(r"wsb_long_dense_kernelILi(\d+)EE")
# kernel 3's wide route (slots a lane, rows, type; the dense family)
_WSB_WIDE = re.compile(r"wsb_wide_kernelILi(\d+)ELb([01])E([fta])E")
_WSB_WIDE_DENSE = re.compile(r"wsb_wide_dense_kernelILi(\d+)EE")
# the affine dense entry's own lane route
_AFFINE_DENSE_LANES = re.compile(r"affine_dp_dense_lanes_kernelILi(\d+)ELi(\d+)ELi(\d)EE")


def ptxas_gate(reports):
    """Each kernel template's registers, stack frame and spills from the
    ptxas reports; raises if an affine template up to T1P = 33, a kernel of
    either affine wide route (the register-resident one at every CPL) or
    a kernel of the WSB register, long or wide route (any entry, any table
    type, tagged or not) or any template of the dense entries has a stack frame
    or spills, or if the reports lack the gather kernels of a table type,
    the row-gather kernels, the tagged ones or the dense ones.  The affine
    register templates past T1P = 33 are printed on a line of their own,
    ungated, and so are the wide_regs templates."""
    from vectorian_tpu_torch.ops.dp_kernels import ptxas_entries

    rows, bad = [], []
    for source, text in reports.items():
        for name, e in ptxas_entries(text).items():
            a, w = _AFFINE_TEMPLATE.search(name), _WSB_REGS_TEMPLATE.search(name)
            aw = _AFFINE_WIDE_TEMPLATE.search(name)
            at, awt = _AFFINE_TAGGED.search(name), _AFFINE_WIDE_TAGGED.search(name)
            wt = _WSB_REGS_TAGGED.search(name)
            ad, awd = _AFFINE_DENSE.search(name), _AFFINE_WIDE_DENSE.search(name)
            wd, wsd = _WSB_REGS_DENSE.search(name), _WSB_DENSE.search(name)
            ar, art = _AFFINE_WIDE_REGS.search(name), _AFFINE_WIDE_REGS_TAGGED.search(name)
            ard = _AFFINE_WIDE_REGS_DENSE.search(name)
            adl = _AFFINE_DENSE_LANES.search(name)
            wp = _WSB_REGS_PAIRED.search(name)
            wl, wld = _WSB_LONG.search(name), _WSB_LONG_DENSE.search(name)
            ww, wwd = _WSB_WIDE.search(name), _WSB_WIDE_DENSE.search(name)
            if ww:
                label = (f"wsb_wide {'rows' if ww[2] == '1' else 'gather'} {_ELEM[ww[3]]} "
                         f"CPL={ww[1]}")
                gated = True
            elif wwd:
                label = f"wsb_wide dense f32 CPL={wwd[1]}"
                gated = True
            elif wl:
                label = (f"wsb_long {'rows' if wl[2] == '1' else 'gather'} {_ELEM[wl[3]]} "
                         f"G={wl[1]}")
                gated = True
            elif wld:
                label = f"wsb_long dense f32 G={wld[1]}"
                gated = True
            elif wp:
                label = (f"wsb_regs gather {_ELEM[wp[4]]} paired L={wp[1]} G={wp[2]} "
                         f"loc={wp[3]} P=2")
                gated = True
            elif adl:
                label = f"affine dense_lanes f32 L={adl[1]} G={adl[2]} loc={adl[3]}"
                gated = True
            elif ar:
                label = (f"affine_wide_regs {'rows' if ar[3] == '1' else 'gather'} "
                         f"{_ELEM[ar[4]]} CPL={ar[1]} loc={ar[2]}")
                gated = True
            elif art:
                label = (f"affine_wide_regs {'rows' if art[3] == '1' else 'gather'} tagged "
                         f"CPL={art[1]} loc={art[2]}")
                gated = True
            elif ard:
                label = f"affine_wide_regs dense f32 CPL={ard[1]} loc={ard[2]}"
                gated = True
            elif ad:
                label = (f"affine dense f32 T1P={ad[1]} loc={ad[2]}"
                         f"{' vec' if ad[3] == '1' else ''}")
                gated = True
            elif wsd:
                label = f"wsb dense f32 loc={wsd[1]} threads={wsd[2]}"
                gated = True
            elif awd:
                label = (f"affine_wide dense f32 loc={awd[1]}"
                         f"{' scratch' if awd[2] == '1' else ''}")
                gated = True
            elif wd:
                label = f"wsb_regs dense f32 L={wd[1]} G={wd[2]} loc={wd[3]} P={wd[4]}"
                gated = True
            elif at:
                label = (f"affine {'rows' if at[3] == '1' else 'gather'} tagged "
                         f"T1P={at[1]} loc={at[2]}{' vec' if at[4] == '1' else ''}")
                gated = int(at[1]) <= 33
            elif awt:
                label = (f"affine_wide {'rows' if awt[2] == '1' else 'gather'} tagged "
                         f"loc={awt[1]}{' scratch' if awt[3] == '1' else ''}")
                gated = True
            elif wt:
                label = (f"wsb_regs {'rows' if wt[5] == '1' else 'gather'} tagged "
                         f"L={wt[1]} G={wt[2]} loc={wt[3]} P={wt[4]}")
                gated = True
            elif a:
                label = (f"affine {'rows' if a[3] == '1' else 'gather'} {_ELEM[a[5]]} "
                         f"T1P={a[1]} loc={a[2]}{' vec' if a[4] == '1' else ''}")
                gated = int(a[1]) <= 33
            elif aw:
                label = (f"affine_wide {'rows' if aw[2] == '1' else 'gather'} "
                         f"{_ELEM[aw[4]]} loc={aw[1]}{' scratch' if aw[3] == '1' else ''}")
                gated = True
            elif w:
                label = (f"wsb_regs {'rows' if w[5] == '1' else 'gather'} {_ELEM[w[6]]} "
                         f"L={w[1]} G={w[2]} loc={w[3]} P={w[4]}")
                gated = True
            else:
                label, gated = f"{source}: {name[:60]}", False
            rows.append([label, e["registers"], e["stack"], e["spill_stores"],
                         e["spill_loads"]])
            if gated and (e["stack"] or e["spill_stores"] or e["spill_loads"]):
                bad.append(label)
    kinds = [f"{k} {e} {t}" for k in ("affine", "affine_wide", "affine_wide_regs", "wsb_regs")
             for e in ("gather", "rows") for t in ("f32", "tagged")]
    kinds += [f"{k} gather {t}" for k in ("affine", "affine_wide", "affine_wide_regs",
                                          "wsb_regs")
              for t in ("bf16", "int8")]
    kinds += [f"{k} dense f32" for k in ("affine", "affine_wide", "affine_wide_regs",
                                         "wsb_regs", "wsb")]
    kinds += ["affine dense_lanes f32"]
    kinds += [f"{k} {e}" for k in ("wsb_long", "wsb_wide")
              for e in ("gather f32", "gather bf16", "gather int8", "rows f32", "dense f32")]
    for kind in kinds:
        if not any(r[0].startswith(kind + " ") for r in rows):
            raise AssertionError(f"ptxas gate: the reports name no {kind} kernel")
    emit({"phase": "ptxas", "kernels_registers_stack_spill_st_ld": sorted(rows)})
    emit({"phase": "ptxas_wide_register_templates",
          "kernels_registers_stack_spill_st_ld": sorted(
              r for r in rows if re.search(r"T1P=65 ", r[0] + " "))})
    emit({"phase": "ptxas_wide_regs_templates",
          "kernels_registers_stack_spill_st_ld": sorted(
              r for r in rows if r[0].startswith("affine_wide_regs "))})
    emit({"phase": "ptxas_dense_templates",
          "kernels_registers_stack_spill_st_ld": sorted(
              r for r in rows if " dense" in r[0])})
    emit({"phase": "ptxas_long_templates",
          "kernels_registers_stack_spill_st_ld": sorted(
              r for r in rows if r[0].startswith("wsb_long "))})
    emit({"phase": "ptxas_wide_general_templates",
          "kernels_registers_stack_spill_st_ld": sorted(
              r for r in rows if r[0].startswith("wsb_wide "))})
    if bad:
        raise AssertionError(f"ptxas gate: stack frame or spills in {bad}")


def load_old_tree(path):
    """The dp_kernels module of the checkout at ``path`` under a name of
    its own (``old_dp_kernels``): its wrappers, and its kernels built from
    that tree's sources into that tree's build directory (it imports the
    rest of the package from this checkout)."""
    import importlib.util

    src = Path(path).resolve() / "vectorian_tpu_torch" / "ops" / "dp_kernels.py"
    if not src.exists():
        raise SystemExit(f"chip_smoke: --old-tree {path} holds no vectorian_tpu_torch")
    spec = importlib.util.spec_from_file_location("old_dp_kernels", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_build(old_reports=False):
    """The build and ptxas gate; with ``--old-tree`` the parent's kernels
    too (``old_reports``: with their ptxas reports, printed)."""
    from vectorian_tpu_torch import native
    from vectorian_tpu_torch.ops import dp_kernels

    t0 = time.perf_counter()

    def one(name):  # one nvcc a source, its own wall time
        t = time.perf_counter()
        return dp_kernels._build_one(name, True), time.perf_counter() - t  # prints ptxas

    with concurrent.futures.ThreadPoolExecutor(len(dp_kernels.SOURCES) + 2) as pool:
        kernels = {name: pool.submit(one, name) for name in dp_kernels.SOURCES}
        host = pool.submit(native.available)
        old = pool.submit(OLD.build, old_reports) if OLD is not None else None
        built = {name: f.result() for name, f in kernels.items()}
        native_ok = host.result()
        if old is not None:
            old.result()
    emit({"phase": "build",
          "libraries": {k: str(v.relative_to(ROOT)) for k, (v, _) in built.items()},
          "source_seconds": {k: t for k, (_, t) in built.items()},
          "native_traceback": bool(native_ok), "old_tree": OLD is not None,
          "seconds": time.perf_counter() - t0})
    ptxas_gate(dp_kernels.PTXAS_REPORTS)


def phase_build_ab():
    """Phase 2's build (both sources, one nvcc each, started together) from
    an empty build directory with NVCC_FLAGS without and with
    ``--split-compile 0`` (nvcc splits a source's kernels over the host's
    cores), each timed.  Run alone: ``python3 chip_smoke.py --build-ab``."""
    from vectorian_tpu_torch.ops import dp_kernels

    flags = dp_kernels.NVCC_FLAGS
    base = tuple(f for i, f in enumerate(flags) if f != "--split-compile"
                 and not (i and flags[i - 1] == "--split-compile"))
    out = {}
    try:
        for label, fl in (("without", base), ("split_compile_0", base + ("--split-compile", "0"))):
            dp_kernels.NVCC_FLAGS = fl
            for name in dp_kernels.SOURCES:
                dp_kernels._library_path(name).unlink(missing_ok=True)
            t0 = time.perf_counter()
            libs = dp_kernels.build()
            out[label] = time.perf_counter() - t0
            for lib in libs.values():
                lib.unlink()
    finally:
        dp_kernels.NVCC_FLAGS = flags
    emit({"phase": "build_ab", "seconds": out, "cores": len(os.sched_getaffinity(0))})


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, sleep_s=0.05):
    """Mean device time of ``fn`` over ``reps`` runs with the host's
    enqueue hidden: a sleep kernel holds the stream while the host queues
    the runs, so the events time the queued work alone (``cuda_ms`` of a
    call of a few microseconds of device work times the host instead).
    Raises if the host took longer to queue than the sleep lasted."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_s * SM_HZ))
    t = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    if host_s > sleep_s:
        raise AssertionError(f"device_ms: queueing took {host_s:.4f} s > the {sleep_s} s sleep")
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    """Host wall ms a call of ``fn``: ``reps`` calls, then a synchronize
    (for a launch of a few microseconds of device work, the host's cost of
    the call; ``device_ms`` times the device's)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def _bound(nbytes, ops):
    """(ms, "bytes" | "operations"): the larger of bytes over the HBM rate
    and f32 operations (single instructions) over the card's f32
    instruction rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / F32_INSTR_RATE * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _affine_row_ops(lt):
    """f32 operations of one affine DP row against a needle of ``lt``
    tokens: 8 + 2 * ceil(log2(columns)) per cell."""
    return (lt + 1) * (8 + 2 * math.ceil(math.log2(lt + 1)))


# f32 operations the tag rewrite adds a similarity cell: the penalty's
# subtract, two multiplies, the threshold's compare and its select
TAG_OPS_PER_CELL = 5


def _tag_bytes(tags):
    """Bytes the tag rewrite reads once: the rows' pos ids and the
    per-query weights, needle pos ids, penalties and thresholds."""
    if tags is None:
        return 0
    return (tags.pos.numel() + tags.w.numel() * 4 + tags.p.numel()
            + tags.pen.numel() * 4 + tags.thr.numel() * 4)


def dp_bound_ms(tokens, len_s, len_t, table, tags=None):
    """Least time for the affine corpus DP on these inputs: bytes (each
    input read once, the table at its element size, the [n, Q] output
    written once) against the f32 operations the data needs — rows up to
    each slice's length, columns up to each needle's length; ``tags`` (a
    TagBlock) adds its bytes and TAG_OPS_PER_CELL a cell the DP reads."""
    n, L = tokens.shape
    Q = table.shape[2]
    nbytes = (
        tokens.numel() * 4 + len_s.numel() * 4 + len_t.numel() * 4
        + table.numel() * table.element_size() + n * Q * 4 + _tag_bytes(tags)
    )
    rows = int(len_s.clamp(1, L).sum())
    per_row = sum(_affine_row_ops(lt) for lt in len_t.tolist())
    if tags is not None:
        per_row += TAG_OPS_PER_CELL * int(len_t.sum())
    return _bound(nbytes, rows * per_row)


def affine_flat_bound_ms(S, len_s, len_t):
    """The same reckoning for the flat affine DP: S [B, L, T] read once."""
    import torch

    B, L, _ = S.shape
    nbytes = S.numel() * 4 + B * 12
    rows = len_s.clamp(0, L).double()
    lt = len_t.double()
    per_row = (lt + 1) * (8 + 2 * torch.ceil(torch.log2(lt + 1)))
    return _bound(nbytes, float((rows * per_row).sum()))


def _wsb_ops(rows, lt):
    """f32 operations of WSB problems with ``rows`` DP rows against needles
    of ``lt`` tokens: the cell at row i, column j pays 2 * i vertical and
    2 * j horizontal candidates and ~4 for the diagonal, the clamp and the
    row max."""
    return lt * rows * (rows + 1) + rows * lt * (lt + 1) + 4 * rows * lt


def wsb_bound_ms(tokens, len_s, len_t, table, tags=None):
    """Least time for the WSB corpus DP on these inputs (bytes: token ids,
    lengths and table (at its element size) in, [n, Q] scores out; ``tags``
    as in ``dp_bound_ms``)."""
    n, L = tokens.shape
    Q = table.shape[2]
    nbytes = (
        tokens.numel() * 4 + len_s.numel() * 4 + len_t.numel() * 4
        + table.numel() * table.element_size() + n * Q * 4 + _tag_bytes(tags)
    )
    rows = len_s.clamp(1, L).double()
    lt = len_t.double()
    ops = (
        float((rows * (rows + 1)).sum()) * float(lt.sum())
        + float(rows.sum()) * float((lt * (lt + 1)).sum())
        + (4 + (TAG_OPS_PER_CELL if tags is not None else 0))
        * float(rows.sum()) * float(lt.sum())
    )
    return _bound(nbytes, ops)


def wsb_flat_bound_ms(S, len_s, len_t):
    B, L, _ = S.shape
    nbytes = S.numel() * 4 + B * 12
    ops = float(_wsb_ops(len_s.clamp(0, L).double(), len_t.double()).sum())
    return _bound(nbytes, ops)


def rows_bound_ms(kernel, tokens, rows, qslot, table, V, len_s, len_t, tags=None):
    """Least time for a row-gather DP on these inputs: bytes of the distinct
    table rows the problems read (each problem's first len_s rows), the
    token ids of the bucket rows they touch, rows, qslot, len_s, len_t and
    the [B] output, against the f32 operations of the DP (``kernel``
    "affine_dp_flat" or "wsb_dp_flat"); ``tags`` adds the touched rows'
    pos ids, the slots' weight block and TAG_OPS_PER_CELL a cell."""
    import torch

    L, T = tokens.shape[1], table.shape[1]
    B = rows.shape[0]
    r = len_s.clamp(0, L).long()
    valid = torch.arange(L, device=r.device)[None, :] < r[:, None]
    ids = (qslot.long()[:, None] * V + tokens[rows.long()].long())[valid]
    touched = torch.unique(rows).numel()
    nbytes = (torch.unique(ids).numel() * T * 4 + touched * L * 4 + B * 4 * 4 + B * 4)
    lt = len_t.double()
    if kernel.startswith("affine_dp_flat"):
        per_row = (lt + 1) * (8 + 2 * torch.ceil(torch.log2(lt + 1)))
        ops = float((r.double() * per_row).sum())
    else:
        ops = float(_wsb_ops(r.double(), lt).sum())
    if tags is not None:
        nbytes += touched * L + _tag_bytes(tags) - tags.pos.numel()
        ops += TAG_OPS_PER_CELL * float((r.double() * lt).sum())
    return _bound(nbytes, ops)


def _gap_models(rng):
    """The two WSB cost models of phase 3: ExponentialGapCost(3.0) and a
    seeded random non-decreasing CustomGapCost."""
    import numpy as np

    from vectorian_tpu_torch.alignment import CustomGapCost, ExponentialGapCost

    steps = np.cumsum(rng.uniform(0.0, 0.35, size=2048)).astype(np.float32)
    return {
        "exponential": ExponentialGapCost(3.0),
        "custom": CustomGapCost(lambda k: float(steps[int(k)])),
    }


def _check_equal(name, got, want, shape):
    import torch

    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite scores at {shape}")
    diff = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{name} != plain at {shape}: max |diff| {diff}")
    return diff


def phase_kernels():
    """affine_dp against its plain version at main-path shapes."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.alignment import AffineGapParams

    rng = np.random.default_rng(SEED)
    V, n = 5_000, AFFINE_N
    gapsets = [(0.0, 0.0, 0.0, 0.0), (0.37, 0.113, 0.29, 0.071)]
    worst = 0.0
    for L in (16, 32):
        for Tpad in (8, 16):
            for Q in (1, 3, 32, 512):
                dev = DEVICE
                # Q = 512: the kernel runs on every slice, its plain version
                # (most of phase 3's time) on the first eighth of them
                m = AFFINE_N // 8 if Q == 512 else n
                table = torch.as_tensor(
                    rng.uniform(-0.4, 1.0, size=(V, Tpad, Q)).astype(np.float32), device=dev)
                tokens = torch.as_tensor(rng.integers(0, V, size=(n, L)).astype(np.int32), device=dev)
                ln = rng.integers(0, L + 1, size=n).astype(np.int32)
                ln[:2] = (0, L)
                len_s = torch.as_tensor(ln, device=dev)
                lt = rng.integers(1, Tpad + 1, size=Q).astype(np.int32)
                lt[0] = Tpad
                len_t = torch.as_tensor(lt, device=dev)
                for loc in LOCALITIES:
                    for gs in gapsets:
                        gaps = AffineGapParams.of(*gs)
                        got = dp_kernels.affine_dp_scores(table, tokens, len_s, len_t, gaps, loc)
                        want = dp_kernels.affine_dp_scores_reference(
                            table, tokens[:m], len_s[:m], len_t, gaps, loc)
                        worst = max(worst, _check_equal(
                            "affine_dp", got[:m], want, (L, Tpad, Q, loc, gs)))
                gaps = AffineGapParams.of(*gapsets[1])
                ms = cuda_ms(lambda: dp_kernels.affine_dp_scores(
                    table, tokens, len_s, len_t, gaps, "local"), 10)
                plain_ms = cuda_ms(lambda: dp_kernels.affine_dp_scores_reference(
                    table, tokens[:m], len_s[:m], len_t, gaps, "local"), 1)
                bound, by = dp_bound_ms(tokens, len_s, len_t, table)
                emit({"phase": "kernel", "name": "affine_dp", "n": n, "L": L,
                      "Tpad": Tpad, "Q": Q, "localities": 3, "gapsets": len(gapsets),
                      "max_abs_diff": 0.0, "kernel_ms": ms, "plain_n": m,
                      "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by})
    return worst


def _turns(a, b, reps):
    """CUDA-event ms of ``a`` and ``b`` in turns (a, b, b, a): (mean of a,
    mean of b, the four times)."""
    t = [cuda_ms(a, reps), cuda_ms(b, reps), cuda_ms(b, reps), cuda_ms(a, reps)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def _affine_gather_inputs(rng, n, L, Tpad, Q, V=5_000):
    """Random [V, Tpad, Q] table, tokens and lengths of an affine
    corpus-pass shape; len_s holds 0 and L, len_t Tpad and 1."""
    import numpy as np
    import torch

    def put(x):
        return torch.as_tensor(x, device=DEVICE)

    ln = rng.integers(0, L + 1, size=n).astype(np.int32)
    ln[:2] = (0, L)
    lt = rng.integers(1, Tpad + 1, size=Q).astype(np.int32)
    lt[0] = Tpad
    if Q > 1:
        lt[1] = 1
    return (put(rng.uniform(-0.4, 1.0, size=(V, Tpad, Q)).astype(np.float32)),
            put(rng.integers(0, V, size=(n, L)).astype(np.int32)), put(ln), put(lt))


def dense_bound_ms(kernel, S, len_s, len_t):
    """Least time for a dense DP entry on these inputs: the cells of the
    [c, L, T, Q] block the DP reads (slice s's rows up to min(max(len_s,
    1), L) by query q's columns up to len_t[q]: 4 * sum_s rows_s * sum_q
    len_t[q] bytes), the lengths and the [c, Q] output moved once, against
    the f32 operations of the DP (``kernel`` "affine_dp[dense]" or
    "wsb_dp[dense]") on the same rows and columns."""
    c, L, _, Q = S.shape
    rows = len_s.clamp(1, L).double()
    lt = len_t.double()
    nbytes = 4 * float(rows.sum()) * float(lt.sum()) + (c + Q) * 4 + c * Q * 4
    if kernel.startswith("affine"):
        ops = float(rows.sum()) * sum(_affine_row_ops(x) for x in len_t.tolist())
    else:
        ops = (float((rows * (rows + 1)).sum()) * float(lt.sum())
               + float(rows.sum()) * float((lt * (lt + 1)).sum())
               + 4 * float(rows.sum()) * float(lt.sum()))
    return _bound(nbytes, ops)


# the contextual vectors' dimension of phase 4f (d = 256: a PCA-compressed
# transformer embedding); it sets the contextual pass's chunk with L, Tpad, Q
CTX_DIM = 256
# phase 4f's corpus: 125,000 of phase 4's sentences (1.2 GB of f32 vectors
# on the host, a 1.0 GB bf16 store on the card): the size at which the
# run's 1,200 s also hold phases 4r and the general long query on a slow
# host (250,000 before them)
CTX_SENTENCES = 125_000


# the dense entries' routes a plan can pick at a register shape, forced
# one at a time for the bit-for-bit checks; "registers" is the design the
# dense entries share with the gather entry
DENSE_ROUTES = {"affine_dp[dense]": ("lanes", "registers"),
                "wsb_dp[dense]": ("registers",)}


def old_dense(run_registers, len_s):
    """The old dense design's device work, the old side of the turns: the
    wrapper's launch that clamped len_s to >= 1 (the kernels clamp it now),
    then the gather entry's register route."""
    import torch

    def fn():
        torch.clamp_min(len_s, 1)
        run_registers()
    return fn


def dense_routes(kernel, S, registers=True):
    """(the route the dense plan picks for the block S [c, L, Tpad, Q],
    the other routes of ``DENSE_ROUTES[kernel]`` it takes there);
    ``registers``: the WSB register routes may run, as
    ``dp_kernels._register_costs`` decides."""
    from vectorian_tpu_torch.ops import dp_kernels

    c, L, Tpad, Q = S.shape
    if kernel == "affine_dp[dense]":
        vec = Q == 1 and Tpad % 4 == 0 and S.data_ptr() % 16 == 0

        def plan(route):
            return dp_kernels.affine_dense_plan(c, L, Tpad, Q, vec, route=route).route
    else:
        def plan(route):
            return dp_kernels.wsb_launch_plan(c * Q, L, Tpad, registers, route=route,
                                              Q=Q).route
    picked, others = plan(None), []
    for route in DENSE_ROUTES[kernel]:
        try:
            plan(route)
        except ValueError:
            continue
        if route != picked:
            others.append(route)
    return picked, others


def device_turns(runs, reps):
    """``device_ms`` of each of ``runs`` ({name: fn}) in turns, the order
    and then its reverse (old, new, new, old for two): {name: mean ms},
    and the times in the order taken."""
    names = list(runs)
    order = names + names[::-1]
    times = [(n, device_ms(runs[n], reps)) for n in order]
    return {n: sum(t for m, t in times if m == n) / 2 for n in names}, times


def phase_kernels_dense():
    """3d: both dense entries (K3: the [c, L, Tpad, Q] block a contextual
    chunk's metric GEMM writes) against their plain versions, bit for bit,
    in 3 localities x 2 affine gap sets / 2 WSB models, at the contextual
    pass's chunk (ops/search.ctx_chunk, d = CTX_DIM) of L 16, Tpad 8, of
    L 8, Tpad 8, of L 16, Tpad 16 and of L 32, Tpad 32, each at Q 32 and
    Q 1: the plan's route and every
    route of ``DENSE_ROUTES`` the plan takes there, forced, each timed on
    the device (``device_ms``) in turns against the old design
    (``old_dense``: old, new, ..., new, old) beside its bound, the plan's
    route also on the host (``host_ms``, a call's wall time).  Then Tpad
    132 (the affine and the WSB wide routes) and, WSB, L 64, and
    the routes no default plan of these shapes takes, forced: the affine
    wide_scratch template at Tpad 132 and the WSB shared template (at L 16
    and 64, Tpad 8: 32 threads a block).  Returns {name: {"worst": |diff|,
    (L, Tpad, Q[, route]): {ms, host_ms, old_ms, route_ms, plain_ms,
    bound_ms, bound_by, c, route}}, "crossover": [...]} (the
    ``dense_crossover`` points)."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.alignment import AffineGapParams
    from vectorian_tpu_torch.ops.search import ctx_chunk

    rng = np.random.default_rng(SEED + 9)
    gapsets = [(0.0, 0.0, 0.0, 0.0), (0.37, 0.113, 0.29, 0.071)]
    models = _gap_models(rng)
    out = {"affine_dp[dense]": {"worst": 0.0}, "wsb_dp[dense]": {"worst": 0.0}}

    def inputs(c, L, Tpad, Q):
        ln = rng.integers(0, L + 1, size=c).astype(np.int32)
        ln[:3] = (0, 1, L)
        lt = rng.integers(1, Tpad + 1, size=Q).astype(np.int32)
        lt[0] = Tpad
        if Q > 1:
            lt[1] = 1
        S = torch.as_tensor(rng.uniform(-0.4, 1.0, size=(c, L, Tpad, Q)).astype(
            np.float32), device=DEVICE)
        return S, torch.as_tensor(ln, device=DEVICE), torch.as_tensor(lt, device=DEVICE)

    def case(kernel, L, Tpad, Q, forced=None, routes=False):
        c = ctx_chunk(L, Tpad, Q, CTX_DIM)
        S, len_s, len_t = inputs(c, L, Tpad, Q)
        if kernel == "affine_dp[dense]":
            variants = [(f"gaps{i}", (AffineGapParams.of(*gs),), {})
                        for i, gs in enumerate(gapsets)]
            fn, ref = dp_kernels.affine_dp_scores_dense, dp_kernels.affine_dp_scores_dense_reference
            registers = True
        else:
            variants = []
            for mname, model in models.items():
                gg = _wsb_general(model, Tpad)
                variants.append((mname, gg.vecs(L), {"host_costs": gg.host_vecs(L)}))
            registers = dp_kernels._register_costs(
                L, Tpad, S, variants[0][1], variants[0][2]["host_costs"]) is not None
            fn, ref = dp_kernels.wsb_dp_scores_dense, dp_kernels.wsb_dp_scores_dense_reference
        picked, others = dense_routes(kernel, S, registers)
        route = forced or picked
        forcings = [forced] + (others if routes else [])
        for loc in LOCALITIES:
            for vname, args, kw in variants:
                want = ref(S, len_s, len_t, *args, loc)
                for f in forcings:
                    got = fn(S, len_s, len_t, *args, loc, _route=f, **kw)
                    out[kernel]["worst"] = max(out[kernel]["worst"], _check_equal(
                        kernel, got, want, (c, L, Tpad, Q, f or route, loc, vname)))
        _, args, kw = variants[-1]

        def run(f):
            return lambda: fn(S, len_s, len_t, *args, "local", _route=f, **kw)

        line = {"c": c, "route": route, "forced": forced is not None}
        if routes:
            # the old design, then the plan's route and every other route
            # it takes, in turns
            runs = {"old": old_dense(run("registers"), len_s), route: run(None)}
            runs.update({f: run(f) for f in forcings[1:]})
            means, times = device_turns(runs, 50)
            line.update(ms=means[route], old_ms=means["old"], route_ms=means, turns=times)
        else:
            line["ms"] = device_ms(run(forced), 50)
        line["host_ms"] = host_ms(run(forced), 10)
        line["plain_ms"] = cuda_ms(lambda: ref(S, len_s, len_t, *args, "local"), 1)
        line["bound_ms"], line["bound_by"] = dense_bound_ms(kernel, S, len_s, len_t)
        out[kernel][(L, Tpad, Q) + ((forced,) if forced else ())] = line
        emit({"phase": "kernel_dense", "name": kernel, "L": L, "Tpad": Tpad, "Q": Q,
              "localities": 3, "variants": len(variants), "max_abs_diff": 0.0,
              "routes_checked": [f or route for f in forcings], **line})

    for kernel in ("affine_dp[dense]", "wsb_dp[dense]"):
        for L, Tpad in ((16, 8), (8, 8), (16, 16), (32, 32)):
            for Q in (32, 1):
                case(kernel, L, Tpad, Q, routes=True)
        for Q in (32, 1):
            case(kernel, 16, 132, Q)
    for Q in (32, 1):
        case("wsb_dp[dense]", 64, 8, Q)
    for Q in (32, 1):
        case("affine_dp[dense]", 16, 132, Q, forced="wide_scratch")
        case("wsb_dp[dense]", 16, 8, Q, forced="shared")
        case("wsb_dp[dense]", 64, 8, Q, forced="shared")
    out["crossover"] = dense_crossover(rng)
    return out


# the problem counts the affine dense plan's threshold
# (dp_kernels.AFFINE_DENSE_LANES_MAX_PROBLEMS) is read at: the chunk of a
# bucket of capacity 16 against needles padded to 8 at Q 32 (c = 2,048 is
# a batch's chunk, fewer a bucket's last) and at Q 1 (c = 8,192 is a
# find's chunk)
CROSSOVER_SLICES = {32: (256, 512, 1_024, 2_048, 4_096), 1: (8_192, 32_768, 131_072)}


def dense_crossover(rng):
    """The affine dense plan's two routes (``DENSE_ROUTES``) at L 16, Tpad
    8, both forced, timed on the device in turns (lanes, registers,
    registers, lanes; ``device_ms`` of 50 launches) at each problem count
    of ``CROSSOVER_SLICES``, on a bucket of capacity 16's length mix:
    slices of 9-16 tokens (the sentences ``DEFAULT_BUCKETS`` puts there)
    and needles of 1-8, seeded; each route bit for bit against the plain
    version (local) first.  Returns the points [{c, Q, problems, ms:
    {route: ms}, plan}]."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.alignment import AffineGapParams

    kernel, L, Tpad = "affine_dp[dense]", 16, 8
    gaps = AffineGapParams.of(0.37, 0.113, 0.29, 0.071)
    fn = dp_kernels.affine_dp_scores_dense
    points = []
    for Q, slices in CROSSOVER_SLICES.items():
        for c in slices:
            S = torch.as_tensor(rng.uniform(-0.4, 1.0, size=(c, L, Tpad, Q)).astype(
                np.float32), device=DEVICE)
            len_s = torch.as_tensor(rng.integers(9, L + 1, size=c).astype(np.int32),
                                    device=DEVICE)
            len_t = torch.as_tensor(rng.integers(1, Tpad + 1, size=Q).astype(np.int32),
                                    device=DEVICE)
            want = dp_kernels.affine_dp_scores_dense_reference(S, len_s, len_t, gaps, "local")
            runs = {}
            for r in DENSE_ROUTES[kernel]:
                _check_equal(kernel, fn(S, len_s, len_t, gaps, "local", _route=r), want,
                             (c, L, Tpad, Q, r, "crossover"))
                runs[r] = (lambda r=r: fn(S, len_s, len_t, gaps, "local", _route=r))
            means, _ = device_turns(runs, 50)
            point = {"c": c, "Q": Q, "problems": c * Q, "ms": means,
                     "plan": dense_routes(kernel, S)[0]}
            points.append(point)
            emit({"phase": "kernel_dense_crossover", "name": kernel, "L": L, "Tpad": Tpad,
                  "len_s": "9-16", "len_t": "1-8", **point})
            del S
    return points


def _shared_wide_route(Tpad):
    """The route the shared-memory wide body takes at Tpad: rows in shared memory
    while a block's fit, else scratch."""
    from vectorian_tpu_torch.ops import dp_kernels

    fits = dp_kernels.AFFINE_WIDE_WARPS * 16 * (Tpad + 1) <= dp_kernels.WSB_SMEM_MAX
    return "wide_shared" if fits else "wide_scratch"


def _quantized(table, variant):
    """The f32 ``table`` as ``variant`` ("f32", "bf16", "int8", "tagged":
    f32) the way stack_query_tables quantizes it."""
    import torch

    if variant == "bf16":
        return table.to(torch.bfloat16)
    if variant == "int8":
        max_abs = torch.clamp_min(table.abs().amax(), 1e-9)
        return torch.round(table / (max_abs / torch.full_like(max_abs, 127.0))).to(torch.int8)
    return table


def phase_kernels_wide():
    """3 (wide routes): the affine entries at needles past the register
    templates against their plain versions, bit for bit, 3 localities x 2
    gap sets: the gather entry (f32, bf16 and int8 tables, tagged), the
    rows entry (f32, tagged) and the dense entry, at Tpad 132 and 256 (L
    16 and 32; Q 1 and 32; B 8,192, 12 slots), each on the register-
    resident wide route (wide_regs) timed in turns against the
    shared-memory route on the same inputs (old, new, new, old), and the
    gather's default call, which splits the launch by needle width, held
    and timed beside them; each time beside its bound.  Then the shared /
    scratch route where the plan
    takes it (Tpad 1,024, 2,048; scratch forced), the register templates
    against wide_regs at Tpad 64, and wide_regs against the shared-memory
    route at Tpad 128.  Returns
    {"affine_dp[wide]", "affine_dp_flat[wide]": worst |diff|, "cases":
    [the emitted lines]}."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.alignment import AffineGapParams
    from vectorian_tpu_torch.ops.search import ctx_chunk

    rng = np.random.default_rng(SEED + 6)
    gapsets = [(0.0, 0.0, 0.0, 0.0), (0.37, 0.113, 0.29, 0.071)]
    aff = AffineGapParams.of(*gapsets[1])
    worst = {"affine_dp[wide]": 0.0, "affine_dp_flat[wide]": 0.0, "cases": []}

    def held(key, name, runs, want, shape):
        """Each of ``runs`` ({label: fn}) bit for bit against ``want``."""
        for label, fn in runs.items():
            d = _check_equal(name, fn(), want, shape + (label,))
            worst[key] = max(worst[key], d)

    def timed(line, runs, route, ab):
        """The line's times: ``route`` against ``ab`` in turns (ab, route,
        route, ab), the gather's default (split) call once more where it
        splits; each also with the host's enqueue hidden (``device_ms``)."""
        if ab:
            old, new, t = _turns(runs[ab], runs[route], 5)
            line.update({"kernel_ms": new, "vs_route": ab, "vs_route_ms": old,
                         "turns_ms": t})
        else:
            line["kernel_ms"] = cuda_ms(runs[route], 5)
        line["queued_kernel_ms"] = device_ms(runs[route], 10)
        if "split" in runs:
            line["split_ms"] = cuda_ms(runs["split"], 5)
            line["queued_split_ms"] = device_ms(runs["split"], 10)
        worst["cases"].append(line)
        emit(line)

    def gather_case(n, L, Tpad, Q, route=None, ab=None, variant="f32"):
        """Kernel vs plain at one gather shape; ``ab`` a route to time
        against (in turns) on the same inputs; the default call too where
        it splits."""
        table, tokens, len_s, len_t = _affine_gather_inputs(rng, n, L, Tpad, Q)
        table = _quantized(table, variant)
        tags = _tag_block(rng, n, L, Q, Tpad) if variant == "tagged" else None
        lt_host = len_t.tolist()
        plan = dp_kernels.affine_launch_plan(n * Q, Tpad, route=route)
        split = route == "wide_regs" and dp_kernels.needle_split(lt_host, Tpad) is not None

        def runs(gaps, loc):
            def call(r=None):
                return lambda: dp_kernels.affine_dp_scores(
                    table, tokens, len_s, len_t, gaps, loc, tags=tags, len_t_host=lt_host,
                    _route=r)
            out = {plan.route: call(route)}
            if ab:
                out[ab] = call(ab)
            if split:
                out["split"] = call()
            return out

        for loc in LOCALITIES:
            for gs in gapsets:
                gaps = AffineGapParams.of(*gs)
                want = dp_kernels.affine_dp_scores_reference(table, tokens, len_s, len_t,
                                                             gaps, loc, tags=tags)
                held("affine_dp[wide]", "affine_dp", runs(gaps, loc), want,
                     (n, L, Tpad, Q, variant, loc, gs))
        r = runs(aff, "local")
        line = {"phase": "kernel_wide", "name": "affine_dp", "entry": "gather",
                "variant": variant, "n": n, "L": L, "Tpad": Tpad, "Q": Q,
                "route": plan.route, "shared_bytes": plan.smem,
                "cpl": dp_kernels.affine_wide_cpl(Tpad) if plan.route == "wide_regs" else 0,
                "localities": 3, "gapsets": len(gapsets), "max_abs_diff": 0.0}
        timed(line, r, plan.route, ab)
        line["plain_ms"] = cuda_ms(lambda: dp_kernels.affine_dp_scores_reference(
            table, tokens, len_s, len_t, aff, "local", tags=tags), 1)
        line["bound_ms"], line["bound_by"] = dp_bound_ms(tokens, len_s, len_t, table, tags)
        emit({"phase": "kernel_wide_plain", "entry": "gather", "variant": variant, "L": L,
              "Tpad": Tpad, "Q": Q, "route": plan.route, "plain_ms": line["plain_ms"],
              "bound_ms": line["bound_ms"], "bound_by": line["bound_by"]})

    def rows_case(B, L, T, slots, route=None, ab=None, tagged=False):
        args = _rows_inputs(rng, B, L, T, slots, n=8_192)
        tags = _tag_block(rng, 8_192, L, slots, T) if tagged else None
        plan = dp_kernels.affine_launch_plan(B, T, rows=True, route=route)

        def runs(gaps, loc):
            def call(r=None):
                return lambda: dp_kernels.affine_dp_scores_rows(*args, gaps, loc, tags=tags,
                                                                _route=r)
            out = {plan.route: call(route)}
            if ab:
                out["rows_" + ab] = call(ab)
            return out

        for loc in LOCALITIES:
            for gs in gapsets:
                gaps = AffineGapParams.of(*gs)
                want = dp_kernels.affine_dp_scores_rows_reference(*args, gaps, loc, tags=tags)
                held("affine_dp_flat[wide]", "affine_dp_scores_rows", runs(gaps, loc), want,
                     (B, L, T, slots, tagged, loc, gs))
        r = runs(aff, "local")
        line = {"phase": "kernel_wide", "name": "affine_dp_flat", "entry": "rows",
                "variant": "tagged" if tagged else "f32", "B": B, "L": L, "T": T,
                "slots": slots, "route": plan.route,
                "cpl": dp_kernels.affine_wide_cpl(T) if plan.route == "rows_wide_regs" else 0,
                "shared_bytes": plan.smem, "localities": 3, "gapsets": len(gapsets),
                "max_abs_diff": 0.0}
        timed(line, r, plan.route, ab and "rows_" + ab)
        line["plain_ms"] = cuda_ms(lambda: dp_kernels.affine_dp_scores_rows_reference(
            *args, aff, "local", tags=tags), 1)
        line["bound_ms"], line["bound_by"] = rows_bound_ms("affine_dp_flat", *args, tags=tags)
        emit({"phase": "kernel_wide_plain", "entry": "rows", "variant": line["variant"],
              "L": L, "T": T, "route": plan.route, "queued_kernel_ms": line["queued_kernel_ms"],
              "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
              "bound_by": line["bound_by"]})

    def dense_case(L, Tpad, Q):
        c = ctx_chunk(L, Tpad, Q, CTX_DIM)
        ln = rng.integers(0, L + 1, size=c).astype(np.int32)
        ln[:3] = (0, 1, L)
        lt = rng.integers(1, Tpad + 1, size=Q).astype(np.int32)
        lt[0] = Tpad
        if Q > 1:
            lt[1] = 1
        S = torch.as_tensor(rng.uniform(-0.4, 1.0, size=(c, L, Tpad, Q)).astype(np.float32),
                            device=DEVICE)
        len_s, len_t = torch.as_tensor(ln, device=DEVICE), torch.as_tensor(lt, device=DEVICE)
        old = _shared_wide_route(Tpad)

        def runs(gaps, loc):
            def call(r=None):
                return lambda: dp_kernels.affine_dp_scores_dense(S, len_s, len_t, gaps, loc,
                                                                 _route=r)
            return {"wide_regs": call("wide_regs"), old: call(old)}

        for loc in LOCALITIES:
            for gs in gapsets:
                gaps = AffineGapParams.of(*gs)
                want = dp_kernels.affine_dp_scores_dense_reference(S, len_s, len_t, gaps, loc)
                held("affine_dp[wide]", "affine_dp[dense]", runs(gaps, loc), want,
                     (c, L, Tpad, Q, loc, gs))
        line = {"phase": "kernel_wide", "name": "affine_dp[dense]", "entry": "dense",
                "variant": "f32", "c": c, "L": L, "Tpad": Tpad, "Q": Q, "route": "wide_regs",
                "cpl": dp_kernels.affine_wide_cpl(Tpad),
                "localities": 3, "gapsets": len(gapsets), "max_abs_diff": 0.0}
        timed(line, runs(aff, "local"), "wide_regs", old)
        line["plain_ms"] = cuda_ms(lambda: dp_kernels.affine_dp_scores_dense_reference(
            S, len_s, len_t, aff, "local"), 1)
        line["bound_ms"], line["bound_by"] = dense_bound_ms("affine_dp[dense]", S, len_s, len_t)
        emit({"phase": "kernel_wide_plain", "entry": "dense", "L": L, "Tpad": Tpad, "Q": Q,
              "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
              "bound_by": line["bound_by"]})

    # the register-resident wide route against the shared-memory one, at every shape
    for Tpad in (132, 256):
        old = _shared_wide_route(Tpad)
        for L in (16, 32):
            for Q in (1, 32):
                gather_case(WIDE_N, L, Tpad, Q, route="wide_regs", ab=old)
                for variant in ("bf16", "int8", "tagged"):
                    gather_case(WIDE_N // 8, L, Tpad, Q, route="wide_regs", ab=old,
                                variant=variant)
            rows_case(WIDE_B, L, Tpad, 12, route="wide_regs", ab=old)
            rows_case(WIDE_B // 4, L, Tpad, 12, route="wide_regs", ab=old, tagged=True)
        for Q in (1, 32):
            dense_case(16, Tpad, Q)
    # past wide_regs' 512 columns the plan takes the shared rows, then scratch
    for L in (16, 32):
        gather_case(WIDE_N, L, 1_024, 1)
        rows_case(WIDE_B, L, 1_024, 12)
    gather_case(1_024, 16, 2_048, 1)
    gather_case(WIDE_N, 16, 256, 32, route="wide_scratch")
    rows_case(WIDE_B, 16, 132, 12, route="wide_scratch")
    # the register templates T1P = 65 against wide_regs at Tpad 64, and
    # Tpad 128 (wide_regs with 4 columns a lane) against the shared-memory route
    for L in (16, 32):
        for Q in (1, 32):
            n = WIDE_N if Q > 1 else AFFINE_N
            gather_case(n, L, 64, Q, route="registers", ab="wide_regs")
            gather_case(n, L, 128, Q, route="wide_regs", ab="wide_shared")
        rows_case(WIDE_B, L, 64, 12, route="registers", ab="wide_regs")
        rows_case(WIDE_B, L, 128, 12, route="wide_regs", ab="wide_shared")
    return worst


def _wsb_general(gap_cost, T):
    """GeneralGaps of ``gap_cost`` on both sides at needle width T."""
    import torch

    from vectorian_tpu_torch.ops.search import GeneralGaps

    return GeneralGaps((gap_cost, gap_cost), T + 1, torch.device(DEVICE))



def _wsb_inputs(rng, n, L, Tpad, Q, V=5_000):
    """Random table, tokens and lengths of a WSB corpus-pass shape; len_s
    holds 0, 1 and L, len_t 1 and Tpad."""
    import numpy as np
    import torch

    table = torch.as_tensor(
        rng.uniform(-0.4, 1.0, size=(V, Tpad, Q)).astype(np.float32), device=DEVICE)
    tokens = torch.as_tensor(rng.integers(0, V, size=(n, L)).astype(np.int32), device=DEVICE)
    ln = rng.integers(0, L + 1, size=n).astype(np.int32)
    ln[:3] = (0, 1, L)[: min(n, 3)]
    lt = rng.integers(1, Tpad + 1, size=Q).astype(np.int32)
    lt[0] = Tpad
    if Q > 1:
        lt[1] = 1
    return (table, tokens, torch.as_tensor(ln, device=DEVICE),
            torch.as_tensor(lt, device=DEVICE))


def phase_kernels_general():
    """wsb_dp (corpus entry, every route) against its plain version;
    returns {"wsb_dp": worst |diff|}."""
    import numpy as np

    from vectorian_tpu_torch.ops import dp_kernels

    rng = np.random.default_rng(SEED + 2)
    models = _gap_models(rng)
    worst = {"wsb_dp": 0.0}
    # the register route at every bucket capacity and needle width it
    # takes; Q = 3 puts problems of two slices (row loops of different
    # lengths) in one warp
    shapes = [(L, T, Q, None) for L in (8, 16, 32) for T in (8, 16, 24, 32)
              for Q in (1, 3, 32)]
    # the one-thread-a-problem routes: what their rule picks at two
    # register-route shapes (shared rows at the main path's, scratch) and at
    # two long-route shapes (phase_kernels_long holds the long route), and
    # the needles the lane routes do not take (scratch)
    shapes += [(16, 8, 32, "rows"), (32, 16, 1, "rows"), (64, 8, 32, "rows"),
               (64, 16, 3, "rows"), (16, 40, 3, None), (256, 64, 32, None)]
    for L, Tpad, Q, route in shapes:
        if L >= 256:
            n = WSB_LONG_SLICES
        else:
            n = max((WSB_PROBLEMS if route else WSB_REG_PROBLEMS) // Q, 8)
        table, tokens, len_s, len_t = _wsb_inputs(rng, n, L, Tpad, Q)
        forced = (dp_kernels.wsb_launch_plan(n * Q, L, Tpad, registers=False).route
                  if route else None)
        plan = dp_kernels.wsb_launch_plan(n * Q, L, Tpad, route=forced, Q=Q)
        if route is None and L <= 32 and Tpad <= 32 and plan.route != "registers":
            raise AssertionError(f"wsb_dp: ({L}, {Tpad}) left the register route")
        for name, model in models.items():
            gg = _wsb_general(model, Tpad)
            vecs, host = gg.vecs(L), gg.host_vecs(L)
            for loc in LOCALITIES:
                got = dp_kernels.wsb_dp_scores(table, tokens, len_s, len_t, *vecs, loc,
                                               host_costs=host, _route=forced)
                want = dp_kernels.wsb_dp_scores_reference(
                    table, tokens, len_s, len_t, *vecs, loc)
                worst["wsb_dp"] = max(worst["wsb_dp"], _check_equal(
                    "wsb_dp", got, want, (n, L, Tpad, Q, plan.route, loc, name)))
        gg = _wsb_general(models["exponential"], Tpad)
        vecs, host = gg.vecs(L), gg.host_vecs(L)
        ms = cuda_ms(lambda: dp_kernels.wsb_dp_scores(
            table, tokens, len_s, len_t, *vecs, "local", host_costs=host,
            _route=forced), 5)
        bound, by = wsb_bound_ms(tokens, len_s, len_t, table)
        emit({"phase": "kernel", "name": "wsb_dp", "n": n, "L": L, "Tpad": Tpad,
              "Q": Q, "route": plan.route, "shared_bytes": plan.smem,
              "localities": 3, "gap_models": len(models), "max_abs_diff": 0.0,
              "kernel_ms": ms, "bound_ms": bound, "bound_by": by})
    # a closure with a negative cost (a gap bonus) leaves the register
    # route for the one-thread-a-problem kernel, and stays exact
    from vectorian_tpu_torch.alignment import CustomGapCost

    L, Tpad, Q = 16, 8, 3
    table, tokens, len_s, len_t = _wsb_inputs(rng, WSB_REG_PROBLEMS // Q, L, Tpad, Q)
    gg = _wsb_general(CustomGapCost(lambda k: -0.05 * k), Tpad)
    before = dict(dp_kernels.WSB_ROUTE_LAUNCHES)
    for loc in LOCALITIES:
        got = dp_kernels.wsb_dp_scores(table, tokens, len_s, len_t, *gg.vecs(L), loc,
                                       host_costs=gg.host_vecs(L))
        want = dp_kernels.wsb_dp_scores_reference(table, tokens, len_s, len_t,
                                                  *gg.vecs(L), loc)
        worst["wsb_dp"] = max(worst["wsb_dp"], _check_equal(
            "wsb_dp", got, want, (L, Tpad, Q, loc, "gap bonus")))
    if dp_kernels.WSB_ROUTE_LAUNCHES["registers"] != before["registers"]:
        raise AssertionError("wsb_dp: a negative closure took the register route")

    return worst


# phase 3's long-route shapes: slices a bucket capacity, each searched by
# Q = 32 queries (and by the first 3 and the first 1 of them: one plain
# version holds the three launches); the plain version's torch scan takes
# L steps over them, in one chunk
LONG_SLICES = {64: 256, 128: 128, 256: 64}
# True (``--long-check``): every gap model on every table type and the
# shared / scratch crossover; else the custom model on f32 tables only
LONG_ALL_MODELS = False
# the old body's shapes the shared / scratch crossover is read at: a gap
# bonus at the lane routes' shapes (its closure keeps it off them) and
# needles past 32 columns, from 352 down to 32 threads resident an SM; each
# at one and two waves of resident blocks and at CROSSOVER_PROBLEMS
CROSSOVER_SHAPES = ((16, 8), (32, 8), (32, 16), (64, 8), (64, 16), (128, 8),
                    (16, 40), (32, 40), (16, 64))
CROSSOVER_PROBLEMS = 65_536


# the shapes kernel 3 still sends to the thread-a-problem body, each held
# and timed once (``old_body_shapes``): (label, L, Tpad, Q, slices, gap
# model, tagged); needles past 32 columns take the wide route where its
# shared memory holds the bucket (phase_kernels_wide_general)
OLD_BODY_SHAPES = (
    ("bucket 512", 512, 8, 32, 16, "exponential", False),
    ("bucket 1024", 1024, 8, 32, 4, "exponential", False),
    ("wide past shared", 64, 256, 32, 64, "exponential", False),
    ("gap bonus", 64, 8, 32, 64, "gap_bonus", False),
    ("tagged", 64, 8, 32, 64, "exponential", True),
)


def old_body_shapes(rng):
    """Kernel 3's gather entry at each of OLD_BODY_SHAPES (the buckets past
    the long route, needles past 32 columns where the wide route's shared
    memory does not hold the bucket (every needle past 32, so the launch
    does not split), a negative closure, a tagged launch past the register
    route): the plan must take the thread-a-problem body; bit for bit
    against the plain version (local), its device ms beside
    ``wsb_bound_ms``.  Returns [line]."""
    from vectorian_tpu_torch.alignment import CustomGapCost
    from vectorian_tpu_torch.ops import dp_kernels

    models = dict(_gap_models(rng), gap_bonus=CustomGapCost(lambda k: -0.05 * k))
    lines, worst = [], 0.0
    for label, L, Tpad, Q, n, mname, tagged in OLD_BODY_SHAPES:
        table, tokens, len_s, len_t = _wsb_inputs(rng, n, L, Tpad, Q)
        if Tpad > dp_kernels.WSB_REG_MAX_T:
            len_t = len_t.clamp_min(dp_kernels.WSB_REG_MAX_T + 1)
        lt_host = len_t.tolist()
        tags = _tag_block(rng, n, L, Q, Tpad) if tagged else None
        gg = _wsb_general(models[mname], Tpad)
        vecs, host = gg.vecs(L), gg.host_vecs(L)
        args = (table, tokens, len_s, len_t, *vecs, "local")
        run = lambda: dp_kernels.wsb_dp_scores(  # noqa: E731
            *args, host_costs=host, tags=tags, len_t_host=lt_host)
        got, used = _with_route(run)
        if used not in ("shared", "scratch"):
            raise AssertionError(f"wsb_dp {label}: took {used!r}, not the old body")
        want, plain_ms = _timed_plain(
            lambda: dp_kernels.wsb_dp_scores_reference(*args, tags=tags))
        worst = max(worst, _check_equal("wsb_dp " + label, got, want, (n, L, Tpad, Q)))
        bound, by = wsb_bound_ms(tokens, len_s, len_t, table, tags)
        line = {"label": label, "n": n, "L": L, "Tpad": Tpad, "Q": Q, "model": mname,
                "tagged": tagged, "route": used, "ms": device_ms(run, _turn_reps({"r": run})),
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
        lines.append(line)
        emit({"phase": "kernel_old_body", "name": "wsb_dp", "max_abs_diff": 0.0, **line})
        del table, tokens
    return lines, worst


def _turn_reps(runs, target_ms=40.0):
    """Launches a ``device_turns`` turn: about ``target_ms`` of the slowest
    run's device time, 2 to 50."""
    slowest = max(cuda_ms(fn, 1) for fn in runs.values())
    return max(2, min(50, int(target_ms / max(slowest, 1e-3))))


def _long_old_routes(problems, L, T):
    """The old body's routes at (L, T): shared where a block's rows fit,
    and scratch."""
    from vectorian_tpu_torch.ops import dp_kernels

    out = ["scratch"]
    try:
        dp_kernels.wsb_launch_plan(problems, L, T, registers=False, route="shared")
        out.insert(0, "shared")
    except ValueError:
        pass
    return out


def _timed_plain(fn):
    """(fn(), its device ms by CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_kernels_long():
    """3 (long buckets): kernel 3's long route (lane groups, column
    histories in shared memory) against its plain version, bit for bit, at
    bucket capacities 64, 128 and 256 x needles padded to 8, 16 and 32 x Q
    1, 3 and 32 (LONG_SLICES slices; slice lengths 0, 1, L and random;
    needle lengths 1 and Tpad among random ones; the Q 3 and Q 1 launches
    read the first queries of the Q 32 table, so one plain version holds
    all three), in 3 localities, ExponentialGapCost(3.0) on f32, bf16 and
    int8 gather tables and a non-decreasing CustomGapCost on f32 (every
    table with LONG_ALL_MODELS); each f32 launch timed on the device in
    turns (``device_turns``) against the old body forced ("shared" where a
    block's rows fit, "scratch"), beside ``wsb_bound_ms``.  The row-gather
    entry at the same L x T (B = 32 LONG_SLICES problems, 12 slots) and
    the dense entry at Q 32 and Q 1 (its first query) the same way, the
    custom model in one locality (every locality with LONG_ALL_MODELS),
    the dense entry in turns too.  Then ``wsb_shared_crossover`` (with
    LONG_ALL_MODELS) and ``old_body_shapes``.  Returns {"worst": |diff|, "turns": [line a
    gather launch], "rows": [...], "dense": [...], "crossover": [...],
    "old_body": [...]}."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.ops import dp_kernels

    rng = np.random.default_rng(SEED + 11)
    models = _gap_models(rng)
    out = {"worst": 0.0, "turns": [], "rows": [], "dense": []}

    def held(label, fn, want, route, shape):
        got, used = _with_route(fn)
        if used != route:
            raise AssertionError(f"{label}: took {used!r}, not {route} at {shape}")
        out["worst"] = max(out["worst"], _check_equal(label, got, want, shape))

    def checks(variant, custom_locs):
        """(model name, locality) pairs a table type or entry is held at:
        the custom model on f32 in ``custom_locs`` only, unless
        LONG_ALL_MODELS."""
        return [(m, loc) for m in models for loc in LOCALITIES
                if LONG_ALL_MODELS or m == "exponential" or (
                    variant == "f32" and loc in custom_locs)]

    for L in (64, 128, 256):
        for Tpad in (8, 16, 32):
            n, Qs = LONG_SLICES[L], (32, 3, 1)
            table, tokens, len_s, len_t = _wsb_inputs(rng, n, L, Tpad, 32)
            plain_ms = None
            for variant in ("f32", "bf16", "int8"):
                tab = _quantized(table, variant)
                for mname, loc in checks(variant, LOCALITIES):
                    gg = _wsb_general(models[mname], Tpad)
                    vecs, host = gg.vecs(L), gg.host_vecs(L)
                    want, ms = _timed_plain(lambda: dp_kernels.wsb_dp_scores_reference(
                        tab, tokens, len_s, len_t, *vecs, loc))
                    if (variant, mname, loc) == ("f32", "exponential", "local"):
                        plain_ms = ms
                    for Q in Qs:
                        tq = tab[:, :, :Q].contiguous()
                        held("wsb_dp long", lambda: dp_kernels.wsb_dp_scores(
                            tq, tokens, len_s, len_t[:Q], *vecs, loc, host_costs=host),
                            want[:, :Q], "long", (n, L, Tpad, Q, variant, mname, loc))
            gg = _wsb_general(models["exponential"], Tpad)
            vecs, host = gg.vecs(L), gg.host_vecs(L)
            for Q in Qs:
                args = (table[:, :, :Q].contiguous(), tokens, len_s, len_t[:Q], *vecs,
                        "local")
                runs = {"long": lambda: dp_kernels.wsb_dp_scores(*args, host_costs=host)}
                first = runs["long"]()
                for r in _long_old_routes(n * Q, L, Tpad):
                    runs[r] = (lambda r=r: dp_kernels.wsb_dp_scores(
                        *args, host_costs=host, _route=r))
                    held("wsb_dp " + r, runs[r], first, r, (n, L, Tpad, Q, "old"))
                means, times = device_turns(runs, _turn_reps(runs))
                old = dp_kernels.wsb_launch_plan(n * Q, L, Tpad, registers=False).route
                bound, by = wsb_bound_ms(tokens, len_s, len_t[:Q], args[0])
                line = {"n": n, "L": L, "Tpad": Tpad, "Q": Q, "ms": means["long"],
                        "old_route": old, "old_ms": means[old], "route_ms": means,
                        "ratio_old": means["long"] / means[old], "turns": times,
                        "bound_ms": bound, "bound_by": by,
                        "threads": dp_kernels.wsb_launch_plan(n * Q, L, Tpad, Q=Q).threads}
                if Q == 32:
                    line["plain_ms"] = plain_ms
                out["turns"].append(line)
                emit({"phase": "kernel_long", "name": "wsb_dp", "entry": "gather",
                      "tables": ["f32", "bf16", "int8"], "all_models": LONG_ALL_MODELS,
                      "localities": 3, "max_abs_diff": 0.0, **line})
            del table, tokens

            # the row-gather entry at this (L, T)
            B = 32 * n
            args = _rows_inputs(rng, B, L, Tpad, 12, n=4_096)
            plain_ms = None
            for mname, loc in checks("f32", ("local",)):
                gg = _wsb_general(models[mname], Tpad)
                vecs, host = gg.vecs(L), gg.host_vecs(L)
                want, ms = _timed_plain(lambda: dp_kernels.wsb_dp_scores_rows_reference(
                    *args, *vecs, loc))
                plain_ms = plain_ms or ms
                held("wsb_dp_scores_rows long", lambda: dp_kernels.wsb_dp_scores_rows(
                    *args, *vecs, loc, host_costs=host), want, "rows_long",
                    (B, L, Tpad, mname, loc))
            gg = _wsb_general(models["exponential"], Tpad)
            vecs, host = gg.vecs(L), gg.host_vecs(L)
            run = lambda: dp_kernels.wsb_dp_scores_rows(  # noqa: E731
                *args, *vecs, "local", host_costs=host)
            bound, by = rows_bound_ms("wsb_dp_flat", *args)
            line = {"B": B, "L": L, "T": Tpad, "slots": 12, "ms": device_ms(run, 10),
                    "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
            out["rows"].append(line)
            emit({"phase": "kernel_long", "name": "wsb_dp_flat", "entry": "rows",
                  "route": "rows_long", "all_models": LONG_ALL_MODELS, "localities": 3,
                  "max_abs_diff": 0.0, **line})
            del args

            # the dense entry at this (L, T): Q 32, and its first query (Q 1)
            c = n
            S = torch.as_tensor(rng.uniform(-0.4, 1.0, size=(c, L, Tpad, 32)).astype(
                np.float32), device=DEVICE)
            ln = rng.integers(0, L + 1, size=c).astype(np.int32)
            ln[:3] = (0, 1, L)
            lt = rng.integers(1, Tpad + 1, size=32).astype(np.int32)
            lt[:2] = (Tpad, 1)
            len_s, len_t = (torch.as_tensor(x, device=DEVICE) for x in (ln, lt))
            blocks = {32: (S, len_t), 1: (S[..., :1].contiguous(), len_t[:1])}
            plain_ms = None
            for mname, loc in checks("f32", ("local",)):
                gg = _wsb_general(models[mname], Tpad)
                vecs, host = gg.vecs(L), gg.host_vecs(L)
                want, ms = _timed_plain(lambda: dp_kernels.wsb_dp_scores_dense_reference(
                    S, len_s, len_t, *vecs, loc))
                plain_ms = plain_ms or ms
                for Q, (SQ, ltQ) in blocks.items():
                    held("wsb_dp[dense] long", lambda: dp_kernels.wsb_dp_scores_dense(
                        SQ, len_s, ltQ, *vecs, loc, host_costs=host), want[:, :Q],
                        "dense_long", (c, L, Tpad, Q, mname, loc))
            gg = _wsb_general(models["exponential"], Tpad)
            vecs, host = gg.vecs(L), gg.host_vecs(L)
            for Q, (SQ, ltQ) in blocks.items():
                dargs = (SQ, len_s, ltQ, *vecs, "local")
                runs = {"long": lambda: dp_kernels.wsb_dp_scores_dense(
                    *dargs, host_costs=host)}
                for r in _long_old_routes(c * Q, L, Tpad):
                    runs[r] = (lambda r=r: dp_kernels.wsb_dp_scores_dense(
                        *dargs, host_costs=host, _route=r))
                means, times = device_turns(runs, _turn_reps(runs))
                old = dp_kernels.wsb_launch_plan(c * Q, L, Tpad, registers=False).route
                bound, by = dense_bound_ms("wsb_dp[dense]", SQ, len_s, ltQ)
                line = {"c": c, "L": L, "Tpad": Tpad, "Q": Q, "ms": means["long"],
                        "old_route": old, "old_ms": means[old], "route_ms": means,
                        "turns": times, "bound_ms": bound, "bound_by": by}
                if Q == 32:
                    line["plain_ms"] = plain_ms
                out["dense"].append(line)
                emit({"phase": "kernel_long", "name": "wsb_dp[dense]", "entry": "dense",
                      "all_models": LONG_ALL_MODELS, "localities": 3, "max_abs_diff": 0.0,
                      **line})
            del S, blocks
    # the crossover WSB_MIN_RESIDENT and the one-wave rule were read at
    # (``--long-check``; the full run holds the old body's routes at
    # old_body_shapes and phases 3, 3t, 3b)
    out["crossover"] = wsb_shared_crossover(rng) if LONG_ALL_MODELS else []
    out["old_body"], worst = old_body_shapes(rng)
    out["worst"] = max(out["worst"], worst)
    return out


# phase 3's wide-needle shapes (kernel 3's wide route): WIDE_SLICES
# slices a shape, each searched by Q = 32 queries (and by the first 3 and
# the first 1 of them: one plain version holds the three launches); the
# plain version's torch scan takes L x Tpad steps over them in one chunk.
# Shapes past the route's shared memory (L 64 x Tpad 256, 512) are the old
# body's and are held in old_body_shapes.
WIDE_SLICES = 256
WIDE_L = (8, 16, 64)
WIDE_T = (40, 64, 136, 256, 512)
# the dense entry at 4f's chunk (c 2,048 slices of bucket 16, Q 32; its
# first query, Q 1) against needles padded to WIDE_DENSE_T
WIDE_DENSE_C = 2_048
WIDE_DENSE_T = (40, 160, 512)
# True (``--wide-general-check``): every gap model on every table type in
# every locality and the rows and dense entries at every width; else each
# table type and locality once a shape (``checks``), the rows and dense
# entries at Tpad 160
WIDE_ALL_MODELS = False


def phase_kernels_wide_general():
    """3 (wide needles): kernel 3's wide route (a warp a problem, its
    columns in register slots, its column history in shared memory)
    against its plain version, bit for bit, at bucket capacities WIDE_L x
    needles padded to WIDE_T x Q 32, 3 and 1 where ``wsb_wide_shape`` holds
    (WIDE_SLICES slices; slice lengths 0, 1, L and random; needle lengths
    1 and Tpad among random ones, so the forced launch meets short needles
    too), ExponentialGapCost(3.0) on f32, bf16 and int8 gather tables in
    "local" and a concave CustomGapCost on f32 in "global" and
    "semiglobal" (every model, table and locality with WIDE_ALL_MODELS),
    forced (``_route="wide"``) and through the default
    call (split by needle: the short needles on the lane routes); each f32
    launch timed on the device in turns (``device_turns``) against the old
    body forced ("shared" where a block's rows fit, "scratch") beside
    ``wsb_bound_ms``.  The row-gather entry at L 16 x the same widths (B =
    32 WIDE_SLICES problems, 12 slots) and the dense entry at 4f's chunk
    (WIDE_DENSE_C slices of bucket 16, Q 32 and its first query) x
    WIDE_DENSE_T, each in turns against the old body.  Returns {"worst":
    |diff|, "turns": [line a gather launch], "rows": [...], "dense":
    [...], "old_body_shapes": [(L, Tpad)]}."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.ops import dp_kernels

    rng = np.random.default_rng(SEED + 19)
    models = _gap_models(rng)
    out = {"worst": 0.0, "turns": [], "rows": [], "dense": [], "old_body_shapes": []}

    def held(label, fn, want, route, shape):
        got, used = _with_route(fn)
        if used != route:
            raise AssertionError(f"{label}: took {used!r}, not {route} at {shape}")
        out["worst"] = max(out["worst"], _check_equal(label, got, want, shape))

    def checks(variant):
        """(model name, locality) pairs a table type or entry is held at:
        every pair with WIDE_ALL_MODELS, else the exponential model in
        "local" on every table and the custom one on f32 in the other two
        localities (each table type and locality once a shape)."""
        return [(m, loc) for m in models for loc in LOCALITIES
                if WIDE_ALL_MODELS or (m == "exponential" and loc == "local") or (
                    m != "exponential" and variant == "f32" and loc != "local")]

    def old_turns(runs, problems, L, T, call, prefix=""):
        """Add the old body's forced routes to ``runs``, each held against
        the first run's output; then the turns."""
        first = runs["wide"]()
        for r in _long_old_routes(problems, L, T):
            runs[r] = (lambda r=r: call(r))
            held("wsb_dp " + r, runs[r], first, prefix + r, (L, T, "old"))
        means, times = device_turns(runs, _turn_reps(runs))
        old = dp_kernels.wsb_launch_plan(problems, L, T, registers=False, wide=False).route
        return means, times, old

    for L in WIDE_L:
        for Tpad in WIDE_T:
            if not dp_kernels.wsb_wide_shape(L, Tpad):
                out["old_body_shapes"].append((L, Tpad))
                continue
            n = WIDE_SLICES
            table, tokens, len_s, len_t = _wsb_inputs(rng, n, L, Tpad, 32)
            lt_host = len_t.tolist()
            plain_ms = None
            for variant in ("f32", "bf16", "int8"):
                tab = _quantized(table, variant)
                for mname, loc in checks(variant):
                    gg = _wsb_general(models[mname], Tpad)
                    vecs, host = gg.vecs(L), gg.host_vecs(L)
                    want, ms = _timed_plain(lambda: dp_kernels.wsb_dp_scores_reference(
                        tab, tokens, len_s, len_t, *vecs, loc))
                    if (variant, mname, loc) == ("f32", "exponential", "local"):
                        plain_ms = ms
                    for Q in (32, 3, 1):
                        tq = tab[:, :, :Q].contiguous()
                        held("wsb_dp wide", lambda: dp_kernels.wsb_dp_scores(
                            tq, tokens, len_s, len_t[:Q], *vecs, loc, host_costs=host,
                            _route="wide"), want[:, :Q], "wide",
                            (n, L, Tpad, Q, variant, mname, loc))
                    # the default call: the split's groups
                    got = dp_kernels.wsb_dp_scores(tab, tokens, len_s, len_t, *vecs, loc,
                                                   host_costs=host, len_t_host=lt_host)
                    out["worst"] = max(out["worst"], _check_equal(
                        "wsb_dp split", got, want, (n, L, Tpad, 32, variant, mname, loc)))
            gg = _wsb_general(models["exponential"], Tpad)
            vecs, host = gg.vecs(L), gg.host_vecs(L)
            for Q in (32, 3, 1):
                args = (table[:, :, :Q].contiguous(), tokens, len_s, len_t[:Q], *vecs,
                        "local")
                runs = {"wide": lambda: dp_kernels.wsb_dp_scores(
                    *args, host_costs=host, _route="wide")}
                means, times, old = old_turns(
                    runs, n * Q, L, Tpad,
                    lambda r: dp_kernels.wsb_dp_scores(*args, host_costs=host, _route=r))
                bound, by = wsb_bound_ms(tokens, len_s, len_t[:Q], args[0])
                line = {"n": n, "L": L, "Tpad": Tpad, "Q": Q, "ms": means["wide"],
                        "old_route": old, "old_ms": means[old], "route_ms": means,
                        "ratio_old": means["wide"] / means[old], "turns": times,
                        "bound_ms": bound, "bound_by": by,
                        "threads": dp_kernels.wsb_launch_plan(n * Q, L, Tpad, Q=Q).threads}
                if Q == 32:
                    line["plain_ms"] = plain_ms
                out["turns"].append(line)
                emit({"phase": "kernel_wide_general", "name": "wsb_dp", "entry": "gather",
                      "tables": ["f32", "bf16", "int8"], "all_models": WIDE_ALL_MODELS,
                      "localities": 3, "max_abs_diff": 0.0, **line})
            del table, tokens

    # the row-gather entry at L 16: one launch at the table's width
    for Tpad in (WIDE_T if WIDE_ALL_MODELS else (160,)):
        L, B = 16, 32 * WIDE_SLICES
        args = _rows_inputs(rng, B, L, Tpad, 12, n=4_096)
        plain_ms = None
        for mname, loc in checks("f32"):
            gg = _wsb_general(models[mname], Tpad)
            vecs, host = gg.vecs(L), gg.host_vecs(L)
            want, ms = _timed_plain(lambda: dp_kernels.wsb_dp_scores_rows_reference(
                *args, *vecs, loc))
            plain_ms = plain_ms or ms
            held("wsb_dp_scores_rows wide", lambda: dp_kernels.wsb_dp_scores_rows(
                *args, *vecs, loc, host_costs=host), want, "rows_wide",
                (B, L, Tpad, mname, loc))
        gg = _wsb_general(models["exponential"], Tpad)
        vecs, host = gg.vecs(L), gg.host_vecs(L)
        run = lambda: dp_kernels.wsb_dp_scores_rows(  # noqa: E731
            *args, *vecs, "local", host_costs=host)
        bound, by = rows_bound_ms("wsb_dp_flat", *args)
        line = {"B": B, "L": L, "T": Tpad, "slots": 12, "ms": device_ms(run, 10),
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
        out["rows"].append(line)
        emit({"phase": "kernel_wide_general", "name": "wsb_dp_flat", "entry": "rows",
              "route": "rows_wide", "all_models": WIDE_ALL_MODELS, "localities": 3,
              "max_abs_diff": 0.0, **line})
        del args

    # the dense entry at 4f's chunk: Q 32, and its first query (Q 1)
    for Tpad in (WIDE_DENSE_T if WIDE_ALL_MODELS else (160,)):
        c, L = WIDE_DENSE_C, 16
        S = torch.as_tensor(rng.uniform(-0.4, 1.0, size=(c, L, Tpad, 32)).astype(
            np.float32), device=DEVICE)
        ln = rng.integers(0, L + 1, size=c).astype(np.int32)
        ln[:3] = (0, 1, L)
        lt = rng.integers(1, Tpad + 1, size=32).astype(np.int32)
        lt[:2] = (Tpad, 1)
        len_s, len_t = (torch.as_tensor(x, device=DEVICE) for x in (ln, lt))
        blocks = {32: (S, len_t), 1: (S[..., :1].contiguous(), len_t[:1])}
        plain_ms = None
        for mname, loc in checks("f32"):
            gg = _wsb_general(models[mname], Tpad)
            vecs, host = gg.vecs(L), gg.host_vecs(L)
            want, ms = _timed_plain(lambda: dp_kernels.wsb_dp_scores_dense_reference(
                S, len_s, len_t, *vecs, loc))
            plain_ms = plain_ms or ms
            for Q, (SQ, ltQ) in blocks.items():
                held("wsb_dp[dense] wide", lambda: dp_kernels.wsb_dp_scores_dense(
                    SQ, len_s, ltQ, *vecs, loc, host_costs=host), want[:, :Q],
                    "dense_wide", (c, L, Tpad, Q, mname, loc))
        gg = _wsb_general(models["exponential"], Tpad)
        vecs, host = gg.vecs(L), gg.host_vecs(L)
        for Q, (SQ, ltQ) in blocks.items():
            dargs = (SQ, len_s, ltQ, *vecs, "local")
            runs = {"wide": lambda: dp_kernels.wsb_dp_scores_dense(*dargs, host_costs=host)}
            means, times, old = old_turns(
                runs, c * Q, L, Tpad,
                lambda r: dp_kernels.wsb_dp_scores_dense(*dargs, host_costs=host, _route=r),
                "dense_")
            bound, by = dense_bound_ms("wsb_dp[dense]", SQ, len_s, ltQ)
            line = {"c": c, "L": L, "Tpad": Tpad, "Q": Q, "ms": means["wide"],
                    "old_route": old, "old_ms": means[old], "route_ms": means,
                    "turns": times, "bound_ms": bound, "bound_by": by}
            if Q == 32:
                line["plain_ms"] = plain_ms
            out["dense"].append(line)
            emit({"phase": "kernel_wide_general", "name": "wsb_dp[dense]", "entry": "dense",
                  "all_models": WIDE_ALL_MODELS, "localities": 3, "max_abs_diff": 0.0,
                  **line})
        del S, blocks
    return out


def wsb_shared_crossover(rng):
    """The old body's two routes ("shared" rows, "scratch") at each of
    CROSSOVER_SHAPES, both forced, each bit for bit against the plain
    version (local) on the largest launch, then timed on the device in
    turns (shared, scratch, scratch, shared) at Q 32 on one wave of the
    shared plan's resident blocks (its resident threads an SM x
    ``dp_kernels.WSB_SMS``), two waves and CROSSOVER_PROBLEMS problems: the
    points ``dp_kernels.WSB_MIN_RESIDENT`` and the one-wave rule are read
    at.  Returns the points [{L, T, problems, resident, ms: {route: ms},
    plan}]."""
    from vectorian_tpu_torch.alignment import CustomGapCost
    from vectorian_tpu_torch.ops import dp_kernels

    bonus = CustomGapCost(lambda k: -0.05 * k)
    expo = _gap_models(rng)["exponential"]
    points = []
    Q = 32
    for L, T in CROSSOVER_SHAPES:
        shared = dp_kernels.wsb_launch_plan(CROSSOVER_PROBLEMS, L, T, registers=False,
                                            route="shared")
        resident = dp_kernels._resident(shared.smem, shared.threads)
        wave = resident * dp_kernels.WSB_SMS
        counts = sorted({max(wave // Q, 1) * Q, 2 * wave // Q * Q, CROSSOVER_PROBLEMS})
        n = counts[-1] // Q
        table, tokens, len_s, len_t = _wsb_inputs(rng, n, L, T, Q)
        gg = _wsb_general(bonus if T <= 32 else expo, T)
        vecs, host = gg.vecs(L), gg.host_vecs(L)
        want = dp_kernels.wsb_dp_scores_reference(table, tokens, len_s, len_t, *vecs, "local")
        for problems in counts:
            m = problems // Q
            args = (table, tokens[:m], len_s[:m], len_t, *vecs, "local")
            runs = {}
            for r in ("shared", "scratch"):
                runs[r] = (lambda r=r: dp_kernels.wsb_dp_scores(*args, host_costs=host,
                                                                _route=r))
                if problems == counts[-1]:
                    got, used = _with_route(runs[r])
                    if used != r:
                        raise AssertionError(f"crossover: took {used!r}, not {r} at {(L, T)}")
                    _check_equal("wsb_dp " + r, got, want, (n, L, T, Q, "crossover"))
            means, _ = device_turns(runs, _turn_reps(runs))
            point = {"L": L, "T": T, "problems": problems, "shared_threads": shared.threads,
                     "resident": resident, "waves": problems / wave, "ms": means,
                     "shared_over_scratch": means["shared"] / means["scratch"],
                     "plan": dp_kernels.wsb_launch_plan(problems, L, T, registers=False).route}
            points.append(point)
            emit({"phase": "kernel_wsb_crossover", "name": "wsb_dp", **point})
        del table, tokens
    return points


def _quant_tables(rng, V, Tpad, Q):
    """Q random [V, Tpad] plans stacked into the f32 serving table and into
    each quantized one (ops/search.stack_query_tables): {sim_dtype: (table,
    sim_scale)}, None for f32."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from vectorian_tpu_torch.ops.search import stack_query_tables

    plans = [SimpleNamespace(matrix=torch.as_tensor(
        rng.uniform(-0.4, 1.0, size=(V, Tpad)).astype(np.float32), device=DEVICE))
        for _ in range(Q)]
    out = {}
    for dt in (None, *QUANT_TAGS):
        table, scale, _, _ = stack_query_tables(plans, [Tpad] * Q, dt)
        # a Tpad off the stack's multiple of 8: its first Tpad columns
        out[dt] = (table[:, :Tpad].contiguous(), scale)
    return out


def _expect_value_error(label, fn):
    try:
        fn()
    except ValueError:
        return
    raise AssertionError(f"{label} was accepted")


def phase_kernels_quant():
    """3b: affine_dp and wsb_dp on bf16 and int8 ranking tables against their
    plain versions, bit for bit, the costs in the table's units
    (ops/search.scaled_costs); each shape timed against the f32 kernel on
    the table before quantizing, in turns (quantized, f32, f32, quantized).
    Returns {"affine_dp[bf16]": worst |diff|, ...}."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.alignment import AffineGapParams
    from vectorian_tpu_torch.ops.search import scaled_costs

    rng = np.random.default_rng(SEED + 5)
    dev = torch.device(DEVICE)
    models = _gap_models(rng)
    gapsets = [(0.0, 0.0, 0.0, 0.0), (0.37, 0.113, 0.29, 0.071)]
    zero = AffineGapParams.of(0, 0, 0, 0)
    worst = {f"{k}[{t}]": 0.0 for k in ("affine_dp", "wsb_dp") for t in QUANT_TAGS.values()}
    shapes = [(L, T, Q, None) for L in (16, 32) for T in (8, 16) for Q in (1, 32)]
    # the one-thread-a-problem routes at one shape each: shared rows, scratch
    shapes += [(16, 8, 32, "rows"), (32, 16, 1, "rows")]
    # kernel 1's packed rows at T1P 33 and 65 (kernel 3: registers at 32
    # columns, its wide route at 64), and a Tpad the affine wrapper pads
    # to whole 8-column chunks (Q 3: kernel 3's one-query groups)
    shapes += [(16, 32, 32, None), (16, 64, 32, "wide"), (16, 12, 3, None)]
    for L, Tpad, Q, route in shapes:
        tables = _quant_tables(rng, 5_000, Tpad, Q)
        f32 = tables[None][0]
        for kernel in ("affine_dp", "wsb_dp"):
            if kernel == "affine_dp":
                if route == "rows":
                    continue
                n = AFFINE_N if Tpad <= 16 else AFFINE_N // 8
            else:
                n = max((WSB_PROBLEMS if route else WSB_REG_PROBLEMS) // Q, 8)
            _, tokens, len_s, len_t = _wsb_inputs(rng, n, L, Tpad, Q)
            forced = (dp_kernels.wsb_launch_plan(n * Q, L, Tpad, registers=False).route
                      if route else None)
            for dt, tag in QUANT_TAGS.items():
                table, scale = tables[dt]
                name = f"{kernel}[{tag}]"
                if kernel == "affine_dp":
                    cases = [(scaled_costs(AffineGapParams.of(*gs), None, scale, Tpad, dev)[0],
                              None, gs) for gs in gapsets]
                    f32_args = (f32, tokens, len_s, len_t, AffineGapParams.of(*gapsets[1]))
                else:
                    cases = [(zero, scaled_costs(zero, (m, m), scale, Tpad, dev)[1], mn)
                             for mn, m in models.items()]
                    gg = _wsb_general(models["exponential"], Tpad)
                    f32_args = (f32, tokens, len_s, len_t, *gg.vecs(L))
                    f32_kw = {"host_costs": gg.host_vecs(L), "_route": forced}
                for gaps, gen, what in cases:
                    for loc in LOCALITIES:
                        if gen is None:
                            args = (table, tokens, len_s, len_t, gaps, loc)
                            got = dp_kernels.affine_dp_scores(*args)
                            want = dp_kernels.affine_dp_scores_reference(*args)
                        else:
                            args = (table, tokens, len_s, len_t, *gen.vecs(L), loc)
                            got, used = _with_route(lambda: dp_kernels.wsb_dp_scores(
                                *args, host_costs=gen.host_vecs(L), _route=forced))
                            want = dp_kernels.wsb_dp_scores_reference(*args)
                            if used != (forced or "registers"):
                                raise AssertionError(f"{name}: took {used} at {(L, Tpad, Q)}")
                        worst[name] = max(worst[name], _check_equal(
                            name, got, want, (n, L, Tpad, Q, loc, what)))
                gaps, gen, _ = cases[-1] if kernel == "affine_dp" else cases[0]
                if kernel == "affine_dp":
                    args = (table, tokens, len_s, len_t, gaps, "local")
                    run = lambda: dp_kernels.affine_dp_scores(*args)  # noqa: E731
                    run32 = lambda: dp_kernels.affine_dp_scores(*f32_args, "local")  # noqa: E731
                    plain = lambda: dp_kernels.affine_dp_scores_reference(*args)  # noqa: E731
                    bound, by = dp_bound_ms(tokens, len_s, len_t, table)
                    reps = 10
                else:
                    args = (table, tokens, len_s, len_t, *gen.vecs(L), "local")
                    kw = {"host_costs": gen.host_vecs(L), "_route": forced}
                    run = lambda: dp_kernels.wsb_dp_scores(*args, **kw)  # noqa: E731
                    run32 = lambda: dp_kernels.wsb_dp_scores(  # noqa: E731
                        *f32_args, "local", **f32_kw)
                    plain = lambda: dp_kernels.wsb_dp_scores_reference(*args)  # noqa: E731
                    bound, by = wsb_bound_ms(tokens, len_s, len_t, table)
                    reps = 5
                turns = [cuda_ms(run, reps), cuda_ms(run32, reps), cuda_ms(run32, reps),
                         cuda_ms(run, reps)]
                emit({"phase": "kernel_quant", "name": name, "n": n, "L": L, "Tpad": Tpad,
                      "Q": Q, "route": (forced if kernel == "wsb_dp" else None) or (
                          "registers" if kernel == "wsb_dp" else "thread_per_problem"),
                      "localities": 3, "cases": len(cases), "max_abs_diff": 0.0,
                      "kernel_ms": (turns[0] + turns[3]) / 2,
                      "f32_kernel_ms": (turns[1] + turns[2]) / 2,
                      "quant_f32_f32_quant_ms": turns, "plain_ms": cuda_ms(plain, 1),
                      "bound_ms": bound, "bound_by": by})
    # a table of any other type raises; nothing upcasts it
    f16 = f32.to(torch.float16)
    gg = _wsb_general(models["exponential"], Tpad)
    _expect_value_error("affine_dp_scores: a float16 table", lambda: dp_kernels.affine_dp_scores(
        f16, tokens, len_s, len_t, zero, "local"))
    _expect_value_error("wsb_dp_scores: a float16 table", lambda: dp_kernels.wsb_dp_scores(
        f16, tokens, len_s, len_t, *gg.vecs(L), "local", host_costs=gg.host_vecs(L)))
    return worst


# 3b's device-time shapes (``quant_turns``): (slices, bucket capacity,
# each slice's length or None for random lengths, Tpad, each needle's
# length, Q).  The main path's (SENTENCES slices of 9 tokens in a bucket of
# 16, needles of 7 padded to 8) at Q 32 and a find's Q 1, then one shape
# each at Tpad 16, 32 and 64 (kernel 3 takes its wide route past 32
# columns, at the slices the scratch route took there before it) and, for
# kernel 1, its wide_regs route at Tpad 132.
QUANT_WIDE_N = 262_144
QUANT_WSB_SCRATCH_N = 16_384
QUANT_WIDE_REGS_N = 32_768


def quant_shapes(kernel):
    shapes = [("main", SENTENCES, 16, 9, 8, 7, 32), ("find", SENTENCES, 16, 9, 8, 7, 1)]
    for T in (16, 32, 64):
        n = QUANT_WSB_SCRATCH_N if kernel == "wsb_dp" and T > 32 else QUANT_WIDE_N
        shapes.append((f"Tpad{T}", n, 16, None, T, T - 1, 32))
    if kernel == "affine_dp":
        shapes.append(("Tpad132", QUANT_WIDE_REGS_N, 16, None, 132, 131, 32))
    return shapes


def quant_turns():
    """3b's device time: each quantized launch of kernels 1 and 3 at
    ``quant_shapes`` against its f32 self on the table before quantizing
    and, with ``--old-tree``, against the parent's kernel on the same
    table, in turns (``device_turns``: new, f32[, old], then back).  Each
    launch is held bit for bit against its plain version on the first
    4,096 slices and against the old one in full.  Returns {name: {shape
    label: line}}."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.alignment import ExponentialGapCost
    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.alignment import AffineGapParams
    from vectorian_tpu_torch.ops.search import scaled_costs

    rng = np.random.default_rng(SEED + 13)
    dev = torch.device(DEVICE)
    model = ExponentialGapCost(3.0)
    affine = AffineGapParams.of(0.37, 0.113, 0.29, 0.071)
    out = {}
    for kernel in ("affine_dp", "wsb_dp"):
        for label, n, L, ln, Tpad, lt, Q in quant_shapes(kernel):
            tables = _quant_tables(rng, 5_000, Tpad, Q)
            tokens = torch.as_tensor(rng.integers(0, 5_000, size=(n, L)).astype(np.int32),
                                     device=dev)
            lens = (np.full(n, ln) if ln else rng.integers(1, L + 1, size=n)).astype(np.int32)
            len_s = torch.as_tensor(lens, device=dev)
            len_t = torch.full((Q,), lt, dtype=torch.int32, device=dev)
            m = 4_096
            for dt, tag in QUANT_TAGS.items():
                table, scale = tables[dt]
                name = f"{kernel}[{tag}]"
                if kernel == "affine_dp":
                    gaps = scaled_costs(affine, None, scale, Tpad, dev)[0]

                    # the lengths on the host: a wide launch's needle split
                    # reads none back (device_ms queues behind a sleep)
                    def call(mod, t=table, g=gaps, tok=tokens, ls=len_s):
                        return mod.affine_dp_scores(t, tok, ls, len_t, g, "local",
                                                    len_t_host=[lt] * Q)
                    run32 = lambda: dp_kernels.affine_dp_scores(  # noqa: E731
                        tables[None][0], tokens, len_s, len_t, affine, "local",
                        len_t_host=[lt] * Q)
                    plain = dp_kernels.affine_dp_scores_reference(
                        table, tokens[:m], len_s[:m], len_t, gaps, "local")
                    bound = dp_bound_ms(tokens, len_s, len_t, table)
                else:
                    gen = scaled_costs(AffineGapParams.of(0, 0, 0, 0), (model, model), scale,
                                       Tpad, dev)[1]
                    vecs, host = gen.vecs(L), gen.host_vecs(L)
                    g32 = _wsb_general(model, Tpad)

                    # the lengths on the host past 32 columns, as above (the
                    # parent's wrapper takes no len_t_host: it does not split)
                    def call(mod, t=table, v=vecs, h=host, tok=tokens, ls=len_s):
                        kw = {"len_t_host": [lt] * Q} if mod is dp_kernels else {}
                        return mod.wsb_dp_scores(t, tok, ls, len_t, *v, "local",
                                                 host_costs=h, **kw)
                    run32 = lambda: dp_kernels.wsb_dp_scores(  # noqa: E731
                        tables[None][0], tokens, len_s, len_t, *g32.vecs(L), "local",
                        host_costs=g32.host_vecs(L), len_t_host=[lt] * Q)
                    plain = dp_kernels.wsb_dp_scores_reference(
                        table, tokens[:m], len_s[:m], len_t, *vecs, "local")
                    bound = wsb_bound_ms(tokens, len_s, len_t, table)
                got, route = _with_route(lambda: call(dp_kernels))
                if kernel == "affine_dp":
                    route = dp_kernels.affine_launch_plan(n * Q, Tpad).route
                err = _check_equal(name, got[:m], plain, (label, n, L, Tpad, Q))
                runs = {"ms": lambda: call(dp_kernels), "f32_ms": run32}
                if OLD is not None:
                    _check_equal(name + " against the parent's", got, call(OLD),
                                 (label, n, L, Tpad, Q))
                    runs["ms_old"] = lambda: call(OLD)
                del got, plain
                means, times = device_turns(runs, 5)
                line = {"phase": "quant_turns", "name": name, "shape": label, "n": n,
                        "L": L, "len_s": ln or "random", "Tpad": Tpad, "len_t": lt, "Q": Q,
                        "route": route or "registers", "max_abs_diff": err, **means,
                        "turns_ms": [[k, t] for k, t in times], "bound_ms": bound[0],
                        "bound_by": bound[1]}
                emit(line)
                out.setdefault(name, {})[label] = line
            del tables, tokens
    return out


_QUANT_TEMPLATES = {
    "affine_dp": re.compile(r"affine_dp_kernel(?:_4b)?ILi(9|17|33)ELi0ELb0ELb([01])E([fta])E"),
    "wsb_dp": re.compile(r"wsb_regs_(?:kernelILi16ELi8ELi0ELi([12])ELb0E|paired_kernel"
                         r"ILi16ELi8ELi0E)([fta])E"),
}


def quant_register_templates(mod, tree, sass_dir=None):
    """The register templates of kernels 1 and 3 at the main path's
    locality (local) and shapes at each table type (``_QUANT_TEMPLATES``:
    affine T1P 9, 17 and 33 gather; WSB bucket 16 against needles of 8,
    one and two queries a group, and the paired loads) in the library of
    the dp_kernels module ``mod`` (``tree`` "new", or "old" for
    ``--old-tree``): ptxas registers, stack and spills, the SASS's
    instruction mix (I2F / I2FP: the int-to-float converts), its
    converts inside innermost loops, and its innermost loops."""
    for lib, pattern in _QUANT_TEMPLATES.items():
        entries = mod.ptxas_entries(mod.PTXAS_REPORTS.get(lib, ""))
        sass = sass_functions(mod._library_path(lib))
        for name, e in sorted(entries.items()):
            m = pattern.search(name)
            if not m:
                continue
            line = {"phase": "quant_register_template", "tree": tree, "name": name,
                    "table": _ELEM[m[m.lastindex]], **e}
            code = (sass or {}).get(name)
            if code is not None:
                ops = [_opcode(ins) for _, ins in code]
                loops = sass_loops(code)
                line["instructions"] = len(ops)
                line["opcodes"] = {op: ops.count(op) for op in SASS_OPS if ops.count(op)}
                line["converts_in_loops"] = sum(c.get("I2F", 0) + c.get("I2FP", 0)
                                                for _, _, c in loops)
                line["innermost_loops"] = loops
                if sass_dir is not None:
                    out = Path(sass_dir) / tree
                    out.mkdir(parents=True, exist_ok=True)
                    (out / f"{name[-60:]}.sass").write_text(
                        "\n".join(f"/*{a:04x}*/ {ins}" for a, ins in code) + "\n")
            else:
                line["sass"] = "cuobjdump not found" if sass is None else "no such function"
            emit(line)


def _rows_inputs(rng, B, L, T, slots, n=ROWS_BUCKET, V=5_000):
    """Row-gather inputs: a stacked [slots * V, T] table, a bucket's [n, L]
    token ids and B (row, slot) problems; len_s holds 0, 1 and L, len_t T
    and 1.  Returns (tokens, rows, qslot, table, V, len_s, len_t)."""
    import numpy as np
    import torch

    def put(x):
        return torch.as_tensor(x, device=DEVICE)

    ln = rng.integers(0, L + 1, size=B).astype(np.int32)
    ln[:3] = (0, 1, L)
    lt = rng.integers(1, T + 1, size=B).astype(np.int32)
    lt[3:5] = (T, 1)
    return (put(rng.integers(0, V, size=(n, L)).astype(np.int32)),
            put(rng.integers(0, n, size=B).astype(np.int32)),
            put(rng.integers(0, slots, size=B).astype(np.int32)),
            put(rng.uniform(-0.4, 1.0, size=(slots * V, T)).astype(np.float32)),
            V, put(ln), put(lt))


def _with_route(fn):
    """(fn(), the WSB route names it launched)."""
    from vectorian_tpu_torch.ops import dp_kernels

    before = dict(dp_kernels.WSB_ROUTE_LAUNCHES)
    out = fn()
    return out, ",".join(k for k, v in dp_kernels.WSB_ROUTE_LAUNCHES.items()
                         if v != before[k])


def phase_kernels_rows():
    """The row-gather entries of the score-only rescore and the flat-batch
    wrappers against their plain versions (every route: the register route
    at L 16 and 32, shared rows and scratch for the gap-bonus model and at
    L=64 and L=256); each row-gather case timed against the gather +
    flat-batch form it replaces (the WSB flat entry forced onto the
    one-thread-a-problem route it took before it had a register route)
    and against its bound.  Returns {name: worst |diff|}."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.alignment import CustomGapCost
    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.alignment import AffineGapParams
    from vectorian_tpu_torch.ops.search import _mq_similarity

    rng = np.random.default_rng(SEED + 4)
    models = _gap_models(rng)
    models["gap_bonus"] = CustomGapCost(lambda k: -0.05 * k)
    gapsets = [(0.0, 0.0, 0.0, 0.0), (0.37, 0.113, 0.29, 0.071)]
    aff = AffineGapParams.of(*gapsets[1])
    worst = {"wsb_dp_flat": 0.0, "affine_dp_flat": 0.0}
    cases = [(B, L, T, slots) for B in ROWS_BATCHES for L in (16, 32)
             for T in (8, 16) for slots in (1, 12)]
    cases += [(8_192, 64, 8, 12), (512, 256, 64, 12)]
    for B, L, T, slots in cases:
        args = _rows_inputs(rng, B, L, T, slots)
        tokens, rows, qslot, table, V, len_s, len_t = args
        shape = (B, L, T, slots)
        routes = {}
        for loc in LOCALITIES:
            for gs in gapsets:
                gaps = AffineGapParams.of(*gs)
                got = dp_kernels.affine_dp_scores_rows(*args, gaps, loc)
                want = dp_kernels.affine_dp_scores_rows_reference(*args, gaps, loc)
                worst["affine_dp_flat"] = max(worst["affine_dp_flat"], _check_equal(
                    "affine_dp_scores_rows", got, want, (*shape, loc, gs)))
            for name, model in models.items():
                gg = _wsb_general(model, T)
                vecs, host = gg.vecs(L), gg.host_vecs(L)
                got, routes[name] = _with_route(lambda: dp_kernels.wsb_dp_scores_rows(
                    *args, *vecs, loc, host_costs=host))
                want = dp_kernels.wsb_dp_scores_rows_reference(*args, *vecs, loc)
                worst["wsb_dp_flat"] = max(worst["wsb_dp_flat"], _check_equal(
                    "wsb_dp_scores_rows", got, want, (*shape, loc, name, routes[name])))
        lane = ("rows_registers" if dp_kernels.wsb_register_shape(L, T) else
                "rows_long" if dp_kernels.wsb_long_shape(L, T) else None)
        if (lane is not None and routes["exponential"] != lane) or (
                routes["gap_bonus"] in ("rows_registers", "rows_long")):
            raise AssertionError(f"wsb_dp_scores_rows: wrong routes {routes} at {shape}")
        gg = _wsb_general(models["exponential"], T)
        vecs, host = gg.vecs(L), gg.host_vecs(L)
        old = dp_kernels.wsb_launch_plan(B, L, T, registers=False).route
        tok = tokens[rows.long()]
        S = _mq_similarity(tok, qslot, table, V)
        for kernel, run, flat, before, plain in (
            ("affine_dp_flat",
             lambda: dp_kernels.affine_dp_scores_rows(*args, aff, "local"),
             lambda: dp_kernels.affine_dp_scores_flat(S, len_s, len_t, aff, "local"),
             lambda: dp_kernels.affine_dp_scores_flat(
                 _mq_similarity(tok, qslot, table, V), len_s, len_t, aff, "local"),
             lambda: dp_kernels.affine_dp_scores_rows_reference(*args, aff, "local")),
            ("wsb_dp_flat",
             lambda: dp_kernels.wsb_dp_scores_rows(*args, *vecs, "local", host_costs=host),
             lambda: dp_kernels.wsb_dp_scores_flat(S, len_s, len_t, *vecs, "local",
                                                   host_costs=host, _route=old),
             lambda: dp_kernels.wsb_dp_scores_flat(
                 _mq_similarity(tok, qslot, table, V), len_s, len_t, *vecs, "local",
                 host_costs=host, _route=old),
             lambda: dp_kernels.wsb_dp_scores_rows_reference(*args, *vecs, "local")),
        ):
            bound, by = rows_bound_ms(kernel, *args)
            emit({"phase": "kernel", "name": kernel, "entry": "rows", "B": B, "L": L,
                  "T": T, "slots": slots,
                  "route": routes["exponential"] if kernel == "wsb_dp_flat" else "thread_per_problem",
                  "routes_by_model": routes if kernel == "wsb_dp_flat" else None,
                  "flat_route": old if kernel == "wsb_dp_flat" else "thread_per_problem",
                  "localities": 3, "max_abs_diff": 0.0,
                  "kernel_ms": cuda_ms(run, 10), "flat_ms": cuda_ms(flat, 10),
                  "gather_plus_flat_ms": cuda_ms(before, 10),
                  "queued_kernel_ms": device_ms(run, 10),
                  "queued_gather_plus_flat_ms": device_ms(before, 10),
                  "plain_ms": cuda_ms(plain, 1), "bound_ms": bound, "bound_by": by})
        del S, tok, args, tokens, table

    # the flat-batch wrappers (the literal counterparts of the Pallas
    # kernels): the same kernels reading S as their table
    B = FLAT_B
    for L in (16, 32):
        for T in (8, 16):
            S = torch.as_tensor(
                rng.uniform(-0.4, 1.0, size=(B, L, T)).astype(np.float32), device=DEVICE)
            ln = rng.integers(0, L + 1, size=B).astype(np.int32)
            ln[:2] = (0, L)  # len_s == 0 passes unclamped and unmasked
            len_s = torch.as_tensor(ln, device=DEVICE)
            len_t = torch.as_tensor(rng.integers(1, T + 1, size=B).astype(np.int32), device=DEVICE)
            for loc in LOCALITIES:
                for name, model in models.items():
                    gg = _wsb_general(model, T)
                    vecs = gg.vecs(L)
                    got = dp_kernels.wsb_dp_scores_flat(S, len_s, len_t, *vecs, loc,
                                                        host_costs=gg.host_vecs(L))
                    want = dp_kernels.wsb_dp_scores_flat_reference(S, len_s, len_t, *vecs, loc)
                    worst["wsb_dp_flat"] = max(worst["wsb_dp_flat"], _check_equal(
                        "wsb_dp_flat", got, want, (B, L, T, loc, name)))
                for gs in gapsets:
                    gaps = AffineGapParams.of(*gs)
                    got = dp_kernels.affine_dp_scores_flat(S, len_s, len_t, gaps, loc)
                    want = dp_kernels.affine_dp_scores_flat_reference(S, len_s, len_t, gaps, loc)
                    worst["affine_dp_flat"] = max(worst["affine_dp_flat"], _check_equal(
                        "affine_dp_flat", got, want, (B, L, T, loc, gs)))
            gg = _wsb_general(models["exponential"], T)
            vecs, host = gg.vecs(L), gg.host_vecs(L)
            old = dp_kernels.wsb_launch_plan(B, L, T, registers=False).route
            route = _with_route(lambda: dp_kernels.wsb_dp_scores_flat(
                S, len_s, len_t, *vecs, "local", host_costs=host))[1]
            for name, run, run_old, plain, bound in (
                ("wsb_dp_flat",
                 lambda: dp_kernels.wsb_dp_scores_flat(S, len_s, len_t, *vecs, "local",
                                                       host_costs=host),
                 lambda: dp_kernels.wsb_dp_scores_flat(S, len_s, len_t, *vecs, "local",
                                                       host_costs=host, _route=old),
                 lambda: dp_kernels.wsb_dp_scores_flat_reference(S, len_s, len_t, *vecs, "local"),
                 wsb_flat_bound_ms(S, len_s, len_t)),
                ("affine_dp_flat",
                 lambda: dp_kernels.affine_dp_scores_flat(S, len_s, len_t, aff, "local"),
                 None,
                 lambda: dp_kernels.affine_dp_scores_flat_reference(S, len_s, len_t, aff, "local"),
                 affine_flat_bound_ms(S, len_s, len_t)),
            ):
                emit({"phase": "kernel", "name": name, "entry": "flat", "B": B, "L": L,
                      "T": T, "route": route if run_old else "thread_per_problem",
                      "localities": 3, "max_abs_diff": 0.0,
                      "kernel_ms": cuda_ms(run, 10),
                      "thread_route_ms": cuda_ms(run_old, 10) if run_old else None,
                      "thread_route": old if run_old else None,
                      "plain_ms": cuda_ms(plain, 1),
                      "bound_ms": bound[0], "bound_by": bound[1]})
    return worst


def _tag_block(rng, n, L, Q, T):
    """A random TagBlock on the card, with the weight table its kernels
    read (``dp_kernels.tag_table``, as a corpus pass builds it): pos ids
    [n, L] of 0-5 and, one in eight, -1, 127 or -128 (every int8 value
    must weight as the plain rewrite does), each of the Q queries' (or
    slots') weights in [0.2, 1.2), needle pos ids of -1-5, penalties in
    [0, 0.5) and thresholds in [-0.1, 0.2)."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.ops import dp_kernels

    def put(x):
        return torch.as_tensor(x, device=DEVICE)

    pos = rng.integers(0, 6, size=(n, L)).astype(np.int8)
    odd = rng.random((n, L)) < 0.125
    pos[odd] = rng.choice(np.asarray([-1, 127, -128], np.int8), size=int(odd.sum()))
    cols = ((rng.random((Q, T)) + 0.2).astype(np.float32),
            rng.integers(-1, 6, size=(Q, T)).astype(np.int8),
            (rng.random(Q) * 0.5).astype(np.float32),
            (rng.random(Q) * 0.3 - 0.1).astype(np.float32))
    return dp_kernels.TagBlock(put(pos), *(put(x) for x in cols + dp_kernels.tag_table(
        *cols[:3])))


def tag_turns(call, reps=5):
    """A tagged launch and its untagged self timed on the device in turns
    (``device_turns``: untagged, tagged, tagged, untagged; with the
    parent's design loaded (``--old-tree``), its tagged and untagged
    launches between them: untagged, tagged, old tagged, old untagged,
    then back), and the host's wall ms a tagged call.  ``call(module,
    tagged)`` runs the entry of a dp_kernels module on the inputs.
    Returns {"ms", "untagged_ms"[, "old_ms", "old_untagged_ms"],
    "host_ms", "turns"}."""
    from vectorian_tpu_torch.ops import dp_kernels

    runs = {"untagged_ms": lambda: call(dp_kernels, False),
            "ms": lambda: call(dp_kernels, True)}
    if OLD is not None:
        runs.update(old_ms=lambda: call(OLD, True),
                    old_untagged_ms=lambda: call(OLD, False))
    means, times = device_turns(runs, reps)
    return {**means, "host_ms": host_ms(runs["ms"], reps),
            "turns": [[n, t] for n, t in times]}


def phase_kernels_tagged():
    """3t: the tagged entries of kernels 1-3 (the tag-weighted block) on
    every route against their plain versions, bit for bit, in 3 localities
    (affine: 2 gap sets; WSB: ExponentialGapCost(3.0)); each timed on the
    device against its untagged self on the same inputs in turns
    (``tag_turns``: with ``--old-tree`` the parent's design too) and
    against its bound (the rewrite's pos bytes and TAG_OPS_PER_CELL a cell
    counted).  Returns the worst |diff| a kernel name."""
    import numpy as np

    from vectorian_tpu_torch.alignment import ExponentialGapCost
    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.alignment import AffineGapParams

    rng = np.random.default_rng(SEED + 9)
    worst = {k: 0.0 for k in ("affine_dp[tagged]", "wsb_dp[tagged]",
                              "affine_dp_flat[tagged]", "wsb_dp_flat[tagged]")}
    gapsets = [AffineGapParams.of(0.0, 0.0, 0.0, 0.0),
               AffineGapParams.of(0.37, 0.113, 0.29, 0.071)]

    def timed(name, plain_tagged, call, bound, **shape):
        t = tag_turns(call, 3)
        b, by = bound
        emit({"phase": "kernel_tagged", "name": name, **shape, "localities": 3,
              "max_abs_diff": 0.0, "kernel_ms": t.pop("ms"), **t,
              "plain_ms": cuda_ms(plain_tagged, 1), "bound_ms": b, "bound_by": by})

    # kernel 1's gather entry: the register templates (T1P 9, 17, 33, 65;
    # Q = 1 reads float4 rows), the wide route's shared and scratch rows
    for n, L, Tpad, Q, route in (
        (AFFINE_N, 16, 8, 32, None), (AFFINE_N, 16, 8, 1, None),
        (AFFINE_N // 4, 16, 16, 3, None), (AFFINE_N // 4, 32, 32, 32, None),
        (AFFINE_N // 8, 16, 64, 5, None), (WIDE_N, 16, 132, 32, None),
        (WIDE_N // 8, 16, 132, 3, "wide_shared"), (WIDE_N // 8, 16, 132, 3, "wide_scratch"),
    ):
        table, tokens, len_s, len_t = _affine_gather_inputs(rng, n, L, Tpad, Q)
        tags = _tag_block(rng, n, L, Q, Tpad)
        plan = dp_kernels.affine_launch_plan(n * Q, Tpad, route=route)
        for loc in LOCALITIES:
            for gaps in gapsets:
                got = dp_kernels.affine_dp_scores(table, tokens, len_s, len_t, gaps, loc,
                                                  tags=tags, _route=route)
                want = dp_kernels.affine_dp_scores_reference(
                    table, tokens, len_s, len_t, gaps, loc, tags=tags)
                worst["affine_dp[tagged]"] = max(worst["affine_dp[tagged]"], _check_equal(
                    "affine_dp[tagged]", got, want, (n, L, Tpad, Q, plan.route, loc)))
        gaps = gapsets[1]
        args = (table, tokens, len_s, len_t, gaps, "local")
        lt_host = len_t.tolist()  # no read of len_t inside the timed calls
        timed("affine_dp[tagged]",
              lambda: dp_kernels.affine_dp_scores_reference(*args, tags=tags),
              lambda m, tagged: m.affine_dp_scores(
                  *args, tags=tags if tagged else None, len_t_host=lt_host, _route=route),
              dp_bound_ms(tokens, len_s, len_t, table, tags),
              n=n, L=L, Tpad=Tpad, Q=Q, route=plan.route)
    # kernel 2 (affine row gather): register templates and the wide route
    for B, L, T, slots in ((FLAT_B, 16, 8, 12), (FLAT_B, 32, 16, 1), (WIDE_B, 16, 132, 12)):
        tokens, rows, qslot, table, V, len_s, len_t = _rows_inputs(rng, B, L, T, slots)
        tags = _tag_block(rng, tokens.shape[0], L, slots, T)
        plan = dp_kernels.affine_launch_plan(B, T, rows=True)
        for loc in LOCALITIES:
            for gaps in gapsets:
                args = (tokens, rows, qslot, table, V, len_s, len_t, gaps, loc)
                got = dp_kernels.affine_dp_scores_rows(*args, tags=tags)
                want = dp_kernels.affine_dp_scores_rows_reference(*args, tags=tags)
                worst["affine_dp_flat[tagged]"] = max(
                    worst["affine_dp_flat[tagged]"], _check_equal(
                        "affine_dp_flat[tagged]", got, want, (B, L, T, slots, plan.route, loc)))
        args = (tokens, rows, qslot, table, V, len_s, len_t, gapsets[1], "local")
        timed("affine_dp_flat[tagged]",
              lambda: dp_kernels.affine_dp_scores_rows_reference(*args, tags=tags),
              lambda m, tagged: m.affine_dp_scores_rows(*args, tags=tags if tagged else None),
              rows_bound_ms("affine_dp_flat", tokens, rows, qslot, table, V, len_s, len_t,
                            tags),
              B=B, L=L, T=T, slots=slots, route=plan.route)
    # kernel 3's gather entry: the register route (group widths 8, 16, 32;
    # one and two queries a group), shared rows (forced), scratch (forced,
    # a 64-token bucket, and the L=256 bucket: "old", the route a tagged
    # launch takes there, so its untagged self runs the same body)
    model = ExponentialGapCost(3.0)
    for L, Tpad, Q, route in ((16, 8, 32, None), (8, 16, 3, None), (32, 32, 32, None),
                              (32, 8, 1, None), (16, 8, 32, "shared"), (64, 16, 3, "old"),
                              (16, 8, 32, "scratch"), (256, 8, 3, "old")):
        n = WSB_LONG_SLICES if L >= 256 else max(WSB_REG_PROBLEMS // Q, 8)
        if route == "old":
            route = dp_kernels.wsb_launch_plan(n * Q, L, Tpad, registers=False).route
        table, tokens, len_s, len_t = _wsb_inputs(rng, n, L, Tpad, Q)
        tags = _tag_block(rng, n, L, Q, Tpad)
        gg = _wsb_general(model, Tpad)
        vecs, host = gg.vecs(L), gg.host_vecs(L)
        used = None
        for loc in LOCALITIES:
            got, used = _with_route(lambda: dp_kernels.wsb_dp_scores(
                table, tokens, len_s, len_t, *vecs, loc, host_costs=host, tags=tags,
                _route=route))
            want = dp_kernels.wsb_dp_scores_reference(table, tokens, len_s, len_t, *vecs,
                                                      loc, tags=tags)
            worst["wsb_dp[tagged]"] = max(worst["wsb_dp[tagged]"], _check_equal(
                "wsb_dp[tagged]", got, want, (n, L, Tpad, Q, used, loc)))
        args = (table, tokens, len_s, len_t, *vecs, "local")
        timed("wsb_dp[tagged]",
              lambda: dp_kernels.wsb_dp_scores_reference(*args, tags=tags),
              lambda m, tagged: m.wsb_dp_scores(*args, host_costs=host,
                                                tags=tags if tagged else None, _route=route),
              wsb_bound_ms(tokens, len_s, len_t, table, tags),
              n=n, L=L, Tpad=Tpad, Q=Q, route=used)
    # kernel 3's row-gather entry: rows_registers, rows_shared (a gap bonus,
    # whose negative closure leaves the register route), rows_scratch
    from vectorian_tpu_torch.alignment import CustomGapCost

    bonus = CustomGapCost(lambda k: -0.05 * k)
    for B, L, T, slots, m in ((FLAT_B, 16, 8, 12, model), (FLAT_B, 16, 8, 12, bonus),
                              (FLAT_B // 8, 64, 16, 12, model),
                              (WSB_LONG_SLICES * 4, 256, 8, 3, model)):
        tokens, rows, qslot, table, V, len_s, len_t = _rows_inputs(rng, B, L, T, slots)
        tags = _tag_block(rng, tokens.shape[0], L, slots, T)
        gg = _wsb_general(m, T)
        vecs, host = gg.vecs(L), gg.host_vecs(L)
        used = None
        for loc in LOCALITIES:
            args = (tokens, rows, qslot, table, V, len_s, len_t, *vecs, loc)
            got, used = _with_route(lambda: dp_kernels.wsb_dp_scores_rows(
                *args, host_costs=host, tags=tags))
            want = dp_kernels.wsb_dp_scores_rows_reference(*args, tags=tags)
            worst["wsb_dp_flat[tagged]"] = max(worst["wsb_dp_flat[tagged]"], _check_equal(
                "wsb_dp_flat[tagged]", got, want, (B, L, T, slots, used, loc)))
        args = (tokens, rows, qslot, table, V, len_s, len_t, *vecs, "local")
        timed("wsb_dp_flat[tagged]",
              lambda: dp_kernels.wsb_dp_scores_rows_reference(*args, tags=tags),
              lambda m, tagged: m.wsb_dp_scores_rows(*args, host_costs=host,
                                                     tags=tags if tagged else None),
              rows_bound_ms("wsb_dp_flat", tokens, rows, qslot, table, V, len_s, len_t,
                            tags),
              B=B, L=L, T=T, slots=slots, route=used)
    return worst



# SASS (cuobjdump -sass): a kernel's name, an instruction (its address and
# text), a label line (newer cuobjdump writes branch targets as labels)
_SASS_FN = re.compile(r"Function : (\S+)")
_SASS_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_BRA = re.compile(r"\bBRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
SASS_OPS = ("LDG", "LDL", "STL", "LDS", "STG", "FMNMX", "FADD", "FMUL", "BRA", "I2F", "I2FP",
            "PRMT")


def sass_functions(lib):
    """{mangled kernel name: [(address, instruction)]} of a built library,
    from ``cuobjdump -sass``; None where cuobjdump is not installed."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    # a branch to a label defined above it (a loop's) gets its address
    out, fn, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = _SASS_FN.search(line)
        if m:
            fn = out.setdefault(m.group(1), [])
            labels, pending = {}, []
            continue
        m = _SASS_LABEL.match(line)
        if m and fn is not None:
            pending.append(m.group(1))
            continue
        m = _SASS_INS.search(line)
        if m and fn is not None:
            addr, ins = int(m.group(1), 16), m.group(2).strip()
            for lab in pending:
                labels[lab] = addr
            pending = []
            b = _SASS_BRA.search(ins)
            if b and b.group(1) in labels:
                ins = ins.replace(f"`({b.group(1)})", hex(labels[b.group(1)]))
            fn.append((addr, ins))
    return out


def _opcode(ins):
    """The base opcode of a SASS instruction (predicate and modifiers off)."""
    words = ins.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def sass_loops(code):
    """The innermost loops of a kernel's SASS (a backward branch and its
    target, holding no other loop): [start, instructions, {op: count}]."""
    loops = []
    for addr, ins in code:
        m = _SASS_BRA.search(ins)
        if m and m.group(2) and _opcode(ins) == "BRA":
            target = int(m.group(2), 16)
            if target <= addr:
                loops.append((target, addr))
    inner = [lp for lp in loops
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    out = []
    for lo, hi in sorted(set(inner)):
        body = [_opcode(ins) for a, ins in code if lo <= a <= hi]
        out.append([hex(lo), len(body), {op: body.count(op) for op in SASS_OPS
                                         if body.count(op)}])
    return out


def phase_tag_check(sass_dir=None):
    """``--tag-check``: the tagged kernels' quick check (phase 2's build and
    ptxas gate, then phases 3t and 3's general-gap kernels, every WSB
    route untagged; both tagged kernels at 4e's shapes; the tagged
    register templates beside their untagged selves, and with
    ``--old-tree`` the parent's), and the WSB shared / scratch route's two
    template families side by side, untagged (wsb_dp_kernel<LOC, GATHER,
    0, float>) against tagged (wsb_dp_tagged_kernel<LOC, GATHER, 0>): their
    ptxas registers, stack and spills, their SASS's instruction mix and
    innermost loops (cuobjdump; the SASS itself into ``sass_dir`` where
    given), and their times on the scratch route's phase-3t shapes in both
    turn orders (untagged first, then tagged first)."""
    import numpy as np

    from vectorian_tpu_torch.alignment import ExponentialGapCost
    from vectorian_tpu_torch.ops import dp_kernels

    phase_build(old_reports=True)
    log("built")
    worst = phase_kernels_tagged()
    worst.update(phase_kernels_general())
    emit({"phase": "tag_check_kernels", "max_abs_diff": worst})
    tag_path_shapes()
    for mod, tree in ((dp_kernels, "new"), (OLD, "old")):
        if mod is not None:
            register_templates(mod, tree, sass_dir)

    templates = {}
    for name, e in dp_kernels.ptxas_entries(dp_kernels.PTXAS_REPORTS["wsb_dp"]).items():
        m = re.search(r"wsb_dp_(tagged_)?kernelILi(\d)ELb([01])ELi0E(f?)E", name)
        if m and (m[1] or m[4]):
            templates[name] = {"tagged": bool(m[1]), "loc": int(m[2]),
                               "entry": "gather" if m[3] == "1" else "rows", **e}
    sass = sass_functions(dp_kernels._library_path("wsb_dp"))
    for name, t in sorted(templates.items(), key=lambda kv: (kv[1]["entry"], kv[1]["loc"],
                                                             kv[1]["tagged"])):
        line = {"phase": "wsb_scratch_template", "name": name, **t}
        code = (sass or {}).get(name)
        if code is not None:
            ops = [_opcode(ins) for _, ins in code]
            line["instructions"] = len(ops)
            line["opcodes"] = {op: ops.count(op) for op in SASS_OPS if ops.count(op)}
            line["innermost_loops"] = sass_loops(code)
            if sass_dir is not None:
                Path(sass_dir).mkdir(parents=True, exist_ok=True)
                (Path(sass_dir) / f"{name[-60:]}.sass").write_text(
                    "\n".join(f"/*{a:04x}*/ {ins}" for a, ins in code) + "\n")
        else:
            line["sass"] = "cuobjdump not found" if sass is None else "no such function"
        emit(line)

    # the scratch route's shapes of phase 3t, timed in both turn orders
    rng = np.random.default_rng(SEED + 11)
    model = ExponentialGapCost(3.0)
    for L, Tpad, Q in ((64, 16, 3), (256, 8, 3)):
        n = WSB_LONG_SLICES if L >= 256 else max(WSB_REG_PROBLEMS // Q, 8)
        table, tokens, len_s, len_t = _wsb_inputs(rng, n, L, Tpad, Q)
        tags = _tag_block(rng, n, L, Q, Tpad)
        gg = _wsb_general(model, Tpad)
        vecs, host = gg.vecs(L), gg.host_vecs(L)
        args = (table, tokens, len_s, len_t, *vecs, "local")
        _tag_turns("wsb_dp", dict(n=n, L=L, Tpad=Tpad, Q=Q),
                   lambda: dp_kernels.wsb_dp_scores(*args, host_costs=host),
                   lambda: dp_kernels.wsb_dp_scores(*args, host_costs=host, tags=tags))
    for B, L, T, slots in ((FLAT_B // 8, 64, 16, 12), (WSB_LONG_SLICES * 4, 256, 8, 3)):
        tokens, rows, qslot, table, V, len_s, len_t = _rows_inputs(rng, B, L, T, slots)
        tags = _tag_block(rng, tokens.shape[0], L, slots, T)
        gg = _wsb_general(model, T)
        vecs, host = gg.vecs(L), gg.host_vecs(L)
        args = (tokens, rows, qslot, table, V, len_s, len_t, *vecs, "local")
        _tag_turns("wsb_dp_flat", dict(B=B, L=L, T=T, slots=slots),
                   lambda: dp_kernels.wsb_dp_scores_rows(*args, host_costs=host),
                   lambda: dp_kernels.wsb_dp_scores_rows(*args, host_costs=host, tags=tags))


# the register templates ``--tag-check`` reports, tagged and untagged, at
# the main path's locality (local) and shapes: affine T1P 9 and 33 (gather,
# float4 rows, row-gather), WSB bucket 16 against needles of 8 (one and two
# queries a group, row-gather); the f32 table's untagged templates end in
# "fE"
_REGISTER_TEMPLATES = {
    "affine_dp": re.compile(
        r"affine_dp_(tagged_)?kernel(?:_4b|_6b)?ILi(9|33)ELi0ELb([01])ELb([01])E(f?)E"),
    "wsb_dp": re.compile(r"wsb_regs_(tagged_)?kernelILi16ELi8ELi0ELi([12])ELb([01])E(f?)E"),
}


def register_templates(mod, tree, sass_dir=None):
    """The tagged register templates of kernels 1 and 3 beside their
    untagged selves (``_REGISTER_TEMPLATES``) in the library of the
    dp_kernels module ``mod`` (``tree``: "new", or "old" for
    ``--old-tree``): ptxas registers, stack and spills, and the SASS's
    instruction mix and innermost loops (cuobjdump; the SASS into
    ``sass_dir/<tree>`` where given)."""
    for lib, pattern in _REGISTER_TEMPLATES.items():
        entries = mod.ptxas_entries(mod.PTXAS_REPORTS.get(lib, ""))
        sass = sass_functions(mod._library_path(lib))
        for name, e in sorted(entries.items()):
            m = pattern.search(name)
            if not m or not (m[1] or m[m.lastindex]):
                continue
            line = {"phase": "register_template", "tree": tree, "name": name,
                    "tagged": bool(m[1]), **e}
            code = (sass or {}).get(name)
            if code is not None:
                ops = [_opcode(ins) for _, ins in code]
                line["instructions"] = len(ops)
                line["opcodes"] = {op: ops.count(op) for op in SASS_OPS if ops.count(op)}
                line["innermost_loops"] = sass_loops(code)
                if sass_dir is not None:
                    out = Path(sass_dir) / tree
                    out.mkdir(parents=True, exist_ok=True)
                    (out / f"{name[-60:]}.sass").write_text(
                        "\n".join(f"/*{a:04x}*/ {ins}" for a, ins in code) + "\n")
            emit(line)


def tag_path_shapes():
    """Both tagged corpus kernels at 4e's tag-weighted pass's shapes on
    random data (the full run times the path's own inputs): SENTENCES
    slices of 9 tokens in a bucket of 16, needles of 7 padded to 8, Q 32
    and a find's Q 1; held against the plain version (local) and timed on
    the device in turns (``tag_turns``) beside the bound."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.alignment import ExponentialGapCost
    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.alignment import AffineGapParams

    rng = np.random.default_rng(SEED + 12)
    n, L, Tpad = SENTENCES, 16, 8
    gaps = AffineGapParams.of(0.37, 0.113, 0.29, 0.071)
    gg = _wsb_general(ExponentialGapCost(3.0), Tpad)
    vecs, host = gg.vecs(L), gg.host_vecs(L)
    tokens = torch.as_tensor(rng.integers(0, 5_000, size=(n, L)).astype(np.int32),
                             device=DEVICE)
    len_s = torch.full((n,), 9, dtype=torch.int32, device=DEVICE)
    for Q in (32, 1):
        table = torch.as_tensor(rng.uniform(-0.4, 1.0, size=(5_000, Tpad, Q)).astype(
            np.float32), device=DEVICE)
        len_t = torch.full((Q,), 7, dtype=torch.int32, device=DEVICE)
        lt_host = [7] * Q
        tags = _tag_block(rng, n, L, Q, Tpad)
        for kernel in ("affine_dp", "wsb_dp"):
            if kernel == "affine_dp":
                args = (table, tokens, len_s, len_t, gaps, "local")

                def call(m, tagged, args=args):
                    return m.affine_dp_scores(*args, tags=tags if tagged else None,
                                              len_t_host=lt_host)
                plain = dp_kernels.affine_dp_scores_reference(*args, tags=tags)
                bound = dp_bound_ms(tokens, len_s, len_t, table, tags)
            else:
                args = (table, tokens, len_s, len_t, *vecs, "local")

                def call(m, tagged, args=args):
                    return m.wsb_dp_scores(*args, host_costs=host,
                                           tags=tags if tagged else None)
                plain = dp_kernels.wsb_dp_scores_reference(*args, tags=tags)
                bound = wsb_bound_ms(tokens, len_s, len_t, table, tags)
            _, route = _with_route(lambda: call(dp_kernels, True))
            err = _check_equal(kernel + "[tagged]", call(dp_kernels, True), plain,
                               ("path", n, L, Tpad, Q))
            del plain
            emit({"phase": "tag_path_shape", "name": kernel + "[tagged]", "n": n, "L": L,
                  "len_s": 9, "Tpad": Tpad, "len_t": 7, "Q": Q, "route": route,
                  "max_abs_diff": err, **tag_turns(call, 5), "bound_ms": bound[0],
                  "bound_by": bound[1]})


def _tag_turns(name, shape, untagged, tagged, reps=10):
    """One line: ``untagged`` and ``tagged`` timed in turns both ways round
    (untagged, tagged, tagged, untagged, then tagged, untagged, untagged,
    tagged), each time the mean of ``reps`` runs."""
    _, route = _with_route(untagged)
    a = _turns(untagged, tagged, reps)[2]
    b = _turns(tagged, untagged, reps)[2]
    emit({"phase": "wsb_scratch_turns", "name": name, **shape, "route": route, "reps": reps,
          "untagged_first_ms": a, "tagged_first_ms": b,
          "untagged_ms": (a[0] + a[3] + b[1] + b[2]) / 4,
          "tagged_ms": (a[1] + a[2] + b[0] + b[3]) / 4})

def zipf_words(V_words=5_000):
    """The corpora's vocabulary: ``V_words`` alphabetic words."""
    def word(i):
        s, i = "", i + 1
        while i:
            s += chr(ord("a") + i % 26)
            i //= 26
        return "w" + s

    return [word(i) for i in range(V_words)]


def zipf_corpus(n_sents, rng):
    """The bench.py e2e corpus: Zipf(1.2) sentences of 9 tokens over 5,000
    alphabetic words, 2,000 sentences per document."""
    import numpy as np

    words = zipf_words()
    V_words = len(words)
    sents_per_doc = min(2_000, n_sents)
    texts = []
    for _ in range(max(n_sents // sents_per_doc, 1)):
        ids = np.minimum(rng.zipf(1.2, size=(sents_per_doc, 9)), V_words - 1)
        texts.append(" ".join(" ".join(words[i] for i in row) + "." for row in ids))

    def query(size=7):
        return " ".join(words[int(i)] for i in np.minimum(rng.zipf(1.2, size=size), V_words - 1))

    return words, texts, query


def build_session(texts, words, vectors, device, extra=(), cls=None):
    """A Session (or ``cls``) over ``texts`` whose first embedding is the
    KeyedVectors "syn" of ``words`` and ``vectors``; ``extra`` embeddings
    follow it."""
    import vectorian_tpu_torch as vt

    emb = vt.KeyedVectors("syn", words, vectors)
    docs = [vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)]
    return (cls or vt.Session)(docs, embeddings=[emb, *extra], device=device)


def make_index(session, gap=None, **span_args):
    """Local alignment over the session's sentences: zero affine gaps (the
    default) or the given gap cost model; ``span_args`` (tag weights) go to
    the OptimizedSpanSim."""
    from vectorian_tpu_torch.alignment import LocalAlignment
    from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim

    emb = session.embeddings[0]
    if gap is None and not span_args:
        return session.partition("sentence").index(EmbeddingTokenSim(emb))
    alignment = LocalAlignment() if gap is None else LocalAlignment(gap)
    return session.partition("sentence").index(
        OptimizedSpanSim(EmbeddingTokenSim(emb), alignment, **span_args))


# 4e's tag weights: the fine tags SimpleNLP gives the Zipf words (NN for
# most, VB / JJ / RB by suffix)
TAG_ARGS = {"tag_weights": {"NN": 0.9, "VB": 0.6, "JJ": 0.5, "RB": 0.8},
            "pos_mismatch_penalty": 0.2, "similarity_threshold": 0.05}


def pairs(result):
    return [(m.slice_id, m.score) for m in result]


def check_results(results, n, min_score):
    for r in results:
        s = [m.score for m in r]
        if len(s) > n or not all(math.isfinite(x) and min_score < x <= 1.0 + 1e-6 for x in s):
            raise AssertionError(f"bad scores {s}")
        if s != sorted(s, reverse=True):
            raise AssertionError(f"unsorted scores {s}")


def profile_calls(label, fn):
    """Device busy time and top kernels of ``fn`` under torch.profiler
    (the profiler's own overhead inflates the wall time it sees): the
    device's own events only (kernels, copies) — a host op (aten::...)
    reports its kernels' time as well, and counting both would double
    every torch op's share.  Returns [(name, ms, launches)] of every
    device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    evs = [e for e in prof.key_averages() if e.self_device_time_total > 0
           and e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        raise AssertionError(f"profile {label}: no device event traced")
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    rows = sorted(([e.key, e.self_device_time_total / 1e3, e.count] for e in evs),
                  key=lambda r: -r[1])
    emit({"phase": "profile", "call": label, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
          "top_kernels_ms_count": [[k[:70], ms, n] for k, ms, n in rows[:8]]})
    return rows


def drive_main_path(index, queries, finds, kernel, label, card, n_sents, profiles=None):
    """find_batch of the queries at each of PRECISIONS and one find per
    ``finds`` entry, with the launch counts set to 0 right before and read
    right after; ``kernel`` must launch at every table type in find_batch
    and (f32) in every find.  Then three warm find_batch calls a precision
    (wall time, extras rounds, row-gather launches, the scale read's wait),
    the precisions and find byte-identical, and the profiles."""
    import numpy as np

    from vectorian_tpu_torch.ops import dp_kernels, search
    from vectorian_tpu_torch.utils import trace

    Q, n, min_score = len(queries), 10, 0.2
    n_slices = index.packed.n_slices
    rows_kernel = kernel + "_flat"
    variants = [kernel] + [f"{kernel}[{t}]" for t in QUANT_TAGS.values()]
    real_round = search.BucketTopKSource.above_exact_many
    rounds = [0]

    def count_round(self, reqs):
        rounds[0] += 1
        return real_round(self, reqs)

    def batch_at(prec):
        return index.find_batch(queries, n=n, min_score=min_score, sim_precision=prec)

    search.BucketTopKSource.above_exact_many = count_round
    try:
        # ---- the main path: launch counts from 0, read right after ----
        dp_kernels.reset_launches()
        for prec in PRECISIONS:
            batch_at(prec)
        launches_batch = dict(dp_kernels.LAUNCHES)
        for v in variants:
            if launches_batch[v] == 0:
                raise AssertionError(f"{label}: find_batch launched no {v} kernel")
        lats = []
        for q in finds:
            before = dp_kernels.LAUNCHES[kernel]
            t = time.perf_counter()
            r = index.find(q, n=n, min_score=min_score)
            lats.append(time.perf_counter() - t)
            if dp_kernels.LAUNCHES[kernel] == before:
                raise AssertionError(f"{label}: a find launched no {kernel} kernel")
            check_results([r], n, min_score)
        launches_find = dp_kernels.LAUNCHES[kernel] - launches_batch[kernel]
        per_prec, batches = {}, {}
        for prec in PRECISIONS:
            times, extras, rows, waits = [], [], [], []
            for _ in range(3):
                r0, l0 = rounds[0], dp_kernels.LAUNCHES[rows_kernel]
                trace.start()
                t = time.perf_counter()
                batches[prec] = batch_at(prec)
                times.append(time.perf_counter() - t)
                spans = trace.stop()
                extras.append(rounds[0] - r0)
                rows.append(dp_kernels.LAUNCHES[rows_kernel] - l0)
                waits.append(sum(dt for name, dt in spans if name == "topk.max_abs_read") * 1e3)
            per_prec[prec or "int8"] = {"times": times, "extras_rounds": extras,
                                        "row_gather_launches": rows, "scale_read_ms": waits}
        singles = [pairs(index.find(q, n=n, min_score=min_score)) for q in queries[:8]]
        launches = dict(dp_kernels.LAUNCHES)
        routes = dict(dp_kernels.WSB_ROUTE_LAUNCHES)
        # ---- end of the main path ----
    finally:
        search.BucketTopKSource.above_exact_many = real_round

    want = [pairs(r) for r in batches["float32"]]
    for prec, batch in batches.items():
        check_results(batch, n, min_score)
        if [pairs(r) for r in batch] != want:
            raise AssertionError(f"{label}: find_batch at {prec or 'int8'} differs from float32")
    if not any(want):
        raise AssertionError(f"{label}: find_batch returned no matches at all")
    if singles != want[:8]:
        raise AssertionError(f"{label}: find and find_batch differ")
    for prec, m in per_prec.items():
        dt_batch = float(np.median(m["times"]))
        emit({"phase": label, "precision": prec, "card": card, "sentences": n_sents,
              "slices": n_slices, "find_batch_Q": Q, "find_batch_s": dt_batch,
              "find_batch_s_all": m["times"], "alignments_per_s": n_slices * Q / dt_batch,
              "extras_rounds": m["extras_rounds"],
              "row_gather_launches": m["row_gather_launches"],
              "scale_read_ms": m["scale_read_ms"]})
    emit({
        "phase": label, "card": card, "sentences": n_sents, "slices": n_slices,
        "find_p50_ms": float(np.percentile(np.asarray(lats) * 1e3, 50)),
        "launches_per_find": launches_find / len(finds),
        "launches_per_find_batch": {v: launches_batch[v] for v in variants},
        "launches": launches,
        "wsb_route_launches": routes,
        "precisions_and_find_byte_identical": True,
    })
    traced = {}
    for prec in ("float32", None):
        call = f"find_batch_Q{Q}_{prec or 'int8'}"
        traced[call] = profile_calls(f"{label}:{call}", lambda: batch_at(prec))
    traced["find"] = profile_calls(f"{label}:find",
                                   lambda: index.find(finds[0], n=n, min_score=min_score))
    if profiles is not None:
        profiles.update(traced)
    return {v: launches[v] for v in variants}, routes


def phase_main_path(session, gap, label, queries, finds, card, n_sents):
    """4 (``gap`` None: zero affine gaps, affine_dp) and 4b (a non-affine
    ``gap``, wsb_dp) on the session's packing; returns the kernel's numbers
    at the shapes the main path gave it: the Q=32 batch at each table type
    (keys "", "[bf16]", "[int8]") and the Q=1 of a find over every bucket.
    f32 wsb_dp is timed on its register route against the
    one-thread-a-problem route, in turns (new, old, old, new); a quantized
    kernel against the f32 one (quantized, f32, f32, quantized)."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.search import scaled_costs, stack_query_tables

    index = make_index(session, gap)
    kernel = "affine_dp" if gap is None else "wsb_dp"
    launches, routes = drive_main_path(index, queries, finds, kernel, label, card, n_sents)
    if gap is not None and routes["registers"] != sum(launches.values()):
        raise AssertionError(f"{label}: wsb_dp left the register route: {routes}")
    engine = index._engine
    dev = torch.device(DEVICE)
    out = {}
    cases = [("", queries, None), ("_find", finds[:1], None)]
    cases += [(f"[{t}]", queries, dt) for dt, t in QUANT_TAGS.items()]
    f32_runs = {}
    for key, qs, dt in cases:
        _, plans, len_ts, _, _, _ = index._prepare_static_batch(qs, 10, 0.2, "float32", {})
        table, scale, _, Tpad = stack_query_tables(plans, len_ts, dt)
        gaps, general, _ = scaled_costs(index._gaps, index._gap_costs, scale, Tpad, dev)
        lt = torch.as_tensor(np.asarray(len_ts, np.int32), device=DEVICE)
        name = kernel + (key if dt else "")
        res = out.setdefault(name, {"launches": launches[name], "max_abs_err": 0.0,
                                    "launch_route": "registers" if gap is not None
                                    else "thread_per_problem"})
        sfx = "_find" if key == "_find" else ""
        ms = plain_ms = bound = f32_ms = 0.0
        ab = []
        by = "operations"
        for bi, db in enumerate(engine._device_buckets):
            L, n = db["capacity"], int(db["n"])
            if gap is None:
                args = (table, db["tokens"], db["lengths"], lt, gaps, "local")
                # bound now: the f32 runs are timed again beside the quantized ones
                run = lambda a=args: dp_kernels.affine_dp_scores(*a)  # noqa: E731
                plain = lambda: dp_kernels.affine_dp_scores_reference(*args)  # noqa: E731
                bound_fn, reps = dp_bound_ms, 20
            else:
                args = (table, db["tokens"], db["lengths"], lt, *general.vecs(L), "local")
                host = general.host_vecs(L)
                old = dp_kernels.wsb_launch_plan(n * len(qs), L, Tpad, registers=False).route
                run = lambda a=args, h=host: dp_kernels.wsb_dp_scores(  # noqa: E731
                    *a, host_costs=h)
                run_old = lambda: dp_kernels.wsb_dp_scores(  # noqa: E731
                    *args, host_costs=host, _route=old)
                plain = lambda: dp_kernels.wsb_dp_scores_reference(*args)  # noqa: E731
                bound_fn, reps = wsb_bound_ms, 5
            want = plain()
            got, used = _with_route(run)
            res["max_abs_err"] = max(res["max_abs_err"], _check_equal(
                name, got, want, f"main-path shapes{key}"))
            if gap is not None and used != "registers":
                raise AssertionError(f"{name}: main-path shapes{key} took {used}")
            if key == "":
                f32_runs[bi] = run
            if dt:
                run32 = f32_runs[bi]
                turns = [cuda_ms(run, reps), cuda_ms(run32, reps), cuda_ms(run32, reps),
                         cuda_ms(run, reps)]
                ab.append({"L": L, "quant_f32_f32_quant_ms": turns})
                ms += (turns[0] + turns[3]) / 2
                f32_ms += (turns[1] + turns[2]) / 2
            elif gap is None:
                ms += cuda_ms(run, reps)
            else:
                _check_equal(kernel, run_old(), want, f"main-path shapes{key}, {old} route")
                turns = [cuda_ms(run, reps), cuda_ms(run_old, reps),
                         cuda_ms(run_old, reps), cuda_ms(run, reps)]
                ab.append({"L": L, "new_old_old_new_ms": turns, "old_route": old})
                ms += (turns[0] + turns[3]) / 2
            plain_ms += cuda_ms(plain, 1)
            b, by = bound_fn(db["tokens"], db["lengths"], lt, table)
            bound += b
        res.update({f"ms{sfx}": ms, f"plain_ms{sfx}": plain_ms,
                    f"bound_ms{sfx}": bound, f"bound_by{sfx}": by,
                    f"shapes_n_L_Tpad_Q{sfx}": [
                        [int(db["n"]), int(db["capacity"]), int(table.shape[1]), len(qs)]
                        for db in engine._device_buckets]})
        if dt:
            res["f32_ms"] = f32_ms
        if ab:
            res[f"ab{sfx}"] = ab
    for name, res in out.items():
        emit({"phase": f"{label}_kernel", "name": name, **res})
    return out


# 4r: a length-mixed corpus: LONG_SENTENCES sentences of log-normal lengths
# (median LONG_MEDIAN tokens, sigma LONG_SIGMA, clipped to LONG_CLIP) over
# phase 4's vocabulary, so kernel 3's buckets 64-256 hold slices (125,000:
# the run's 1,200 s hold the wide route's phases too; 250,000 before them)
LONG_SENTENCES = 125_000
LONG_MEDIAN = 18
LONG_SIGMA = 0.55
LONG_CLIP = (3, 250)


def lognormal_corpus(words, n_sents, rng):
    """``n_sents`` sentences over ``words``, each of rint(lognormal(log(
    LONG_MEDIAN), LONG_SIGMA)) tokens clipped to LONG_CLIP, its words drawn
    Zipf(1.2) as in ``zipf_corpus``; 2,000 sentences a document.  Returns
    (texts, a 7-token query maker, the lengths)."""
    import numpy as np

    V_words = len(words)
    lengths = np.clip(np.rint(rng.lognormal(math.log(LONG_MEDIAN), LONG_SIGMA, size=n_sents)),
                      *LONG_CLIP).astype(np.int64)
    ids = np.minimum(rng.zipf(1.2, size=int(lengths.sum())), V_words - 1)
    ends = np.cumsum(lengths)
    sents = [" ".join(words[i] for i in ids[e - n:e]) + "." for e, n in zip(ends, lengths)]
    texts = [" ".join(sents[i:i + 2_000]) for i in range(0, n_sents, 2_000)]

    def query(size=7):
        return " ".join(words[int(i)] for i in np.minimum(rng.zipf(1.2, size=size), V_words - 1))

    return texts, query, lengths


def launch_device_ms(fns, sleep_s=0.05):
    """Device ms of each of ``fns`` run once in order, by CUDA events around
    each (a warm run first; a sleep kernel holds the stream while the host
    queues them all, so a gap of host time never counts).  Raises if the
    host took longer to queue than the sleep lasted."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in fns]
    torch.cuda._sleep(int(sleep_s * SM_HZ))
    t = time.perf_counter()
    for (start, end), fn in zip(evs, fns):
        start.record()
        fn()
        end.record()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    if host_s > sleep_s:
        raise AssertionError(f"launch_device_ms: queueing took {host_s:.4f} s")
    return [start.elapsed_time(end) for start, end in evs]


def prose_queries(words, k=32):
    """``k`` queries of prose length: rint(lognormal(log(LONG_MEDIAN),
    LONG_SIGMA)) tokens clipped to LONG_CLIP, as 4r's sentences, their
    words drawn Zipf(1.2) over ``words``, from a generator of their own
    (seed SEED + 20)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 20)
    lengths = np.clip(np.rint(rng.lognormal(math.log(LONG_MEDIAN), LONG_SIGMA, size=k)),
                      *LONG_CLIP).astype(np.int64)
    return [" ".join(words[int(i)] for i in np.minimum(rng.zipf(1.2, size=int(n)),
                                                        len(words) - 1)) for n in lengths]


def phase_prose_batch(index, words, card):
    """4r, prose-length queries: one find_batch of 32 ``prose_queries`` on
    4r's general-gap index at each ranking precision, the launch counts
    set to 0 right before and read right after.  At least one query is
    longer than WSB_REG_MAX_T tokens, so the pass splits by needle width:
    each bucket's gather launches must be the split's two groups on the
    routes ``wsb_launch_plan`` gives them (the short needles on the lane
    routes over their own columns, the wide ones on the wide route where
    it takes the bucket, else the old body), one launch a group a bucket a
    batch; every precision byte-identical, and to the ``find`` of each wide
    query and of four short ones.
    Returns the wide route's launches and the batches' wall ms."""
    import numpy as np

    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.search import stack_query_tables

    qs = prose_queries(words)
    _, plans, len_ts, _, _, _ = index._prepare_static_batch(qs, 10, 0.01, "float32", {})
    Tpad = stack_query_tables(plans, len_ts)[3]
    split = dp_kernels.needle_split(len_ts, Tpad, dp_kernels.WSB_REG_MAX_T)
    if max(len_ts) <= dp_kernels.WSB_REG_MAX_T or split is None or not split.long:
        raise AssertionError(f"prose batch: needles {len_ts} hold none past 32 tokens")
    want = {}
    for L, nb in ((int(db["capacity"]), int(db["n"])) for db in index._engine._live_buckets()):
        if nb == 0:
            continue
        for group, T in ((split.short, split.short_T), (split.long, Tpad)):
            Q = len(group)
            r = dp_kernels.wsb_launch_plan(nb * Q, L, T, Q=Q).route
            want[r] = want.get(r, 0) + len(PRECISIONS)
    n, min_score = 10, 0.01
    # ---- the main path: launch counts from 0, read right after ----
    dp_kernels.reset_launches()
    batches, wall = {}, {}
    for prec in PRECISIONS:
        t = time.perf_counter()
        batches[prec] = [pairs(r) for r in index.find_batch(qs, n=n, min_score=min_score,
                                                             sim_precision=prec)]
        wall[prec or "int8"] = (time.perf_counter() - t) * 1e3
    routes = dict(dp_kernels.WSB_ROUTE_LAUNCHES)
    # ---- end of the main path ----
    got = {r: v for r, v in routes.items() if v and not r.startswith("rows_")}
    if got != want:
        raise AssertionError(f"prose batch: gather launches {got}, planned {want}")
    for prec, b in batches.items():
        if b != batches["float32"]:
            raise AssertionError(f"prose batch: find_batch at {prec or 'int8'} differs from f32")
    # each wide query's find and four short ones' (a find a query: ~0.8 s)
    held = split.long + split.short[:4]
    finds = [pairs(index.find(qs[q], n=n, min_score=min_score)) for q in held]
    if finds != [batches["float32"][q] for q in held]:
        raise AssertionError("prose batch: find and find_batch differ")
    if not all(batches["float32"]):
        raise AssertionError("prose batch: a query without matches")
    emit({"phase": "prose_batch", "card": card, "needle_tokens": len_ts, "Tpad": Tpad,
          "short_T": split.short_T, "wide_queries": len(split.long), "find_batch_ms": wall,
          "route_launches": {k: v for k, v in routes.items() if v},
          "planned_gather_launches": want, "precisions_and_find_byte_identical": True})
    return {"launches": routes["wide"], "find_batch_ms": wall, "needle_tokens": len_ts,
            "route_launches": {k: v for k, v in routes.items() if v}}


def phase_long_path(words, vectors, card):
    """4r: the general-gap path on a length-mixed corpus.  LONG_SENTENCES
    sentences (``lognormal_corpus``) over phase 4's vocabulary and vectors,
    Session(device="cuda") -> partition("sentence") ->
    LocalAlignment(ExponentialGapCost(3.0)); ``drive_main_path``: find_batch
    Q=32 at int8, bf16 and f32 (median of 3), 21 finds (p50), the launch
    counts set to 0 right before and read right after, byte-identical.
    Every bucket up to 32 tokens must take the register route and every
    one of 33-256 the long route, each at least once.  Per bucket, for the
    Q=32 batch at f32 and int8 and a find's Q=1: the kernel against its
    plain version bit for bit on the path's own tables and tokens, its
    launch's device ms in one pass (``launch_device_ms``; a torch.profiler
    trace of the pass beside it gives each kernel template's device ms and
    launches: its per-event list dropped launches on the card), each long
    bucket's launch in turns against the old body forced on the same
    tensors (``device_turns``), beside its bound.  Between the two, the
    prose-length batch (``phase_prose_batch``: a needle past 32 tokens
    splits the pass, the wide route on the path).
    Returns the kernel line's numbers of the long route (the prose batch's
    under "prose")."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.alignment import ExponentialGapCost
    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.search import scaled_costs, stack_query_tables

    rng = np.random.default_rng(SEED + 12)
    texts, query, lengths = lognormal_corpus(words, LONG_SENTENCES, rng)
    t0 = time.perf_counter()
    session = build_session(texts, words, vectors, DEVICE)
    index = make_index(session, ExponentialGapCost(3.0))
    t_build = time.perf_counter() - t0
    engine = index._engine
    buckets = [(int(db["capacity"]), int(db["n"])) for db in engine._device_buckets]
    emit({"phase": "long_path_build", "sentences": LONG_SENTENCES,
          "slices": index.packed.n_slices, "host_build_s": t_build,
          "length_mean": float(lengths.mean()), "length_median": float(np.median(lengths)),
          "buckets_capacity_slices": buckets})
    log(f"4r host build {t_build:.1f} s, buckets {buckets}")
    queries = [query() for _ in range(32)]
    finds = [query() for _ in range(21)]
    traced = {}
    launches, routes = drive_main_path(index, queries, finds, "wsb_dp", "long_path", card,
                                       LONG_SENTENCES, profiles=traced)
    log("4r main path done")
    prose = phase_prose_batch(index, words, card)
    log("4r prose-length batch done")
    want_routes = {"registers" if L <= dp_kernels.WSB_REG_MAX_L else "long"
                   for L, _ in buckets}
    # extras rounds, where a cut is unsafe, take the row-gather twins
    if not all(routes[r] for r in want_routes) or any(
            v for r, v in routes.items() if r.removeprefix("rows_") not in want_routes):
        raise AssertionError(f"long_path: routes {routes}, want {sorted(want_routes)}")

    dev = torch.device(DEVICE)
    # each kernel 3 template's device ms and launches in the traced calls
    # (the long buckets share one template; a trace of one pass alone, a
    # few ms, came back without device events on the card)
    out = {"launches": routes["long"], "launches_by_route": routes,
           "launches_by_table": launches, "buckets": [], "max_abs_err": 0.0,
           "prose": prose,
           "profiler": {call: {k: [ms, c] for k, ms, c in rows if "wsb_" in k}
                        for call, rows in traced.items()}}
    for key, qs, dt in (("Q32", queries, None), ("Q32_int8", queries, "int8"),
                        ("Q1", finds[:1], None)):
        _, plans, len_ts, _, _, _ = index._prepare_static_batch(qs, 10, 0.2, "float32", {})
        table, scale, _, Tpad = stack_query_tables(plans, len_ts, dt)
        _, general, _ = scaled_costs(index._gaps, index._gap_costs, scale, Tpad, dev)
        lt = torch.as_tensor(np.asarray(len_ts, np.int32), device=DEVICE)
        calls = []
        for db in engine._device_buckets:
            L = int(db["capacity"])
            args = (table, db["tokens"], db["lengths"], lt, *general.vecs(L), "local")
            calls.append((L, int(db["n"]), args, general.host_vecs(L)))

        fns = [lambda a=a, h=h: dp_kernels.wsb_dp_scores(*a, host_costs=h)
               for _, _, a, h in calls]
        pass_ms = launch_device_ms(fns)
        for (L, n, args, host), launch_ms in zip(calls, pass_ms):
            route = "registers" if L <= dp_kernels.WSB_REG_MAX_L else "long"
            run = lambda a=args, h=host: dp_kernels.wsb_dp_scores(*a, host_costs=h)  # noqa: E731
            plain = lambda a=args: dp_kernels.wsb_dp_scores_reference(*a)  # noqa: E731
            got, used = _with_route(run)
            if used != route:
                raise AssertionError(f"long_path {key}: bucket {L} took {used}")
            # the register route at the int8 and Q 1 shapes is held in 3b
            # and 4b; here at f32 Q 32
            held = route == "long" or key == "Q32"
            if held:
                want = plain()
                err = _check_equal("wsb_dp", got, want, f"long_path {key}, bucket {L}")
                out["max_abs_err"] = max(out["max_abs_err"], err)
            line = {"case": key, "L": L, "n": n, "Tpad": int(table.shape[1]), "Q": len(qs),
                    "table": str(table.dtype).replace("torch.", ""), "route": route,
                    "pass_ms": launch_ms}
            if route == "long":
                old = dp_kernels.wsb_launch_plan(n * len(qs), L, Tpad, registers=False).route
                run_old = lambda a=args, h=host, o=old: dp_kernels.wsb_dp_scores(  # noqa: E731
                    *a, host_costs=h, _route=o)
                _check_equal("wsb_dp", run_old(), want, f"long_path {key}, bucket {L}, {old}")
                runs = {"long": run, old: run_old}
                means, times = device_turns(runs, _turn_reps(runs, 100.0))
                line.update(ms=means["long"], old_route=old, old_ms=means[old],
                            ratio_old=means["long"] / means[old], turns=times)
            else:
                line["ms"] = device_ms(run, _turn_reps({"r": run}, 100.0))
            line["plain_ms"] = cuda_ms(plain, 1) if held else None
            line["bound_ms"], line["bound_by"] = wsb_bound_ms(args[1], args[2], lt, table)
            out["buckets"].append(line)
            emit({"phase": "long_path_bucket", "card": card, **line})
        log(f"4r buckets at {key} done")
        del calls, table
    del index, session
    return out


def _option_cases(words):
    """4e's options: (name, index keyword arguments, query keyword arguments,
    precisions of find_batch).  The filter drops two frequent words and
    every ADV token; the booster weighs slices holding either of two
    frequent words up by at most 1.6x."""
    import vectorian_tpu_torch as vt

    booster = vt.Saliency(strength=0.6).add_signal(vt.KeywordSignal(words[2], words[6]))
    return [
        ("tag_weights", TAG_ARGS, {}, ("float32",)),
        ("filter", {}, {"token_filter": [words[0], words[3]], "pos_filter": ["ADV"]},
         (None, "bfloat16", "float32")),
        ("booster", {}, {"booster": booster}, (None, "bfloat16", "float32")),
        ("bidirectional", {}, {"bidirectional": True}, (None,)),
    ]


def drive_option(index, queries, finds, kernel, name, kw, precisions):
    """One 4e option: find_batch at each precision and one find a ``finds``
    entry, the launch counts set to 0 right before and read right after;
    then three warm find_batch calls a precision (wall time, extras rounds).
    Every precision and find give the same bytes.  Returns (the launches,
    {precision: times and extras rounds}, find p50 ms)."""
    import numpy as np

    from vectorian_tpu_torch.ops import dp_kernels, search

    n, min_score = 10, 0.2
    real_round = search.BucketTopKSource.above_exact_many
    rounds = [0]

    def count_round(self, reqs):
        rounds[0] += 1
        return real_round(self, reqs)

    search.BucketTopKSource.above_exact_many = count_round
    try:
        # ---- the option's path: launch counts from 0, read right after ----
        dp_kernels.reset_launches()
        batches = {p: index.find_batch(queries, n=n, min_score=min_score, sim_precision=p,
                                       **kw) for p in precisions}
        lats, singles = [], []
        for q in finds:
            t = time.perf_counter()
            singles.append(pairs(index.find(q, n=n, min_score=min_score, **kw)))
            lats.append(time.perf_counter() - t)
        launches = {k: v for k, v in dp_kernels.LAUNCHES.items() if v}
        # ---- end of the option's path ----
        per_prec = {}
        for p in precisions:
            times, extras = [], []
            for _ in range(3):
                r0 = rounds[0]
                t = time.perf_counter()
                index.find_batch(queries, n=n, min_score=min_score, sim_precision=p, **kw)
                times.append(time.perf_counter() - t)
                extras.append(rounds[0] - r0)
            per_prec[p or "int8"] = {"times": times, "extras_rounds": extras}
        check = [pairs(index.find(q, n=n, min_score=min_score, **kw)) for q in queries[:8]]
    finally:
        search.BucketTopKSource.above_exact_many = real_round
    want = [pairs(r) for r in batches[precisions[-1]]]
    for p, batch in batches.items():
        check_results(batch, n, min_score)
        if [pairs(r) for r in batch] != want:
            raise AssertionError(f"4e {name}: find_batch at {p or 'int8'} differs")
    if not any(want):
        raise AssertionError(f"4e {name}: find_batch returned no matches at all")
    if check != want[:8]:
        raise AssertionError(f"4e {name}: find and find_batch differ")
    if not any(singles):
        raise AssertionError(f"4e {name}: no find returned a match")
    # find ranks with f32; a quantized batch with its table type's kernel
    variants = {kernel + ("[tagged]" if name == "tag_weights" else "")}
    for p in precisions:
        if p != "float32":
            variants.add(f"{kernel}[{QUANT_TAGS[p or 'int8']}]")
    for v in variants:
        if not launches.get(v):
            raise AssertionError(f"4e {name}: the path launched no {v} kernel: {launches}")
    return launches, per_prec, float(np.percentile(np.asarray(lats) * 1e3, 50))


def tagged_kernel_at_path(index, qs, kernel):
    """The tagged corpus kernel at the shapes 4e's tag-weighted pass gave
    it (the batch's f32 table, its tag columns and weight table, every
    bucket's pos ids), held against its plain version and timed on the
    device against its untagged self in turns (``tag_turns``; with
    ``--old-tree`` the parent's design too); returns (max |diff|, {"ms",
    "untagged_ms", "host_ms"[, "old_ms", "old_untagged_ms"]} summed over
    the buckets, plain ms, bound ms, bound_by, shapes)."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.dp_kernels import TagBlock
    from vectorian_tpu_torch.ops.search import (
        corpus_tag_columns, scaled_costs, stack_query_tables, tag_arrays,
    )

    engine = index._engine
    dev = torch.device(DEVICE)
    _, plans, len_ts, _, tagws, _ = index._prepare_static_batch(qs, 10, 0.2, "float32", {})
    table, scale, _, Tpad = stack_query_tables(plans, len_ts, None)
    gaps, general, _ = scaled_costs(index._gaps, index._gap_costs, scale, Tpad, dev)
    cols = [torch.as_tensor(c, device=dev)
            for c in tag_arrays(corpus_tag_columns(tagws, len(qs), Tpad))]
    lt = torch.as_tensor(np.asarray(len_ts, np.int32), device=dev)
    worst = plain_ms = bound = 0.0
    times = {}
    by, shapes = "operations", []
    for db in engine._device_buckets:
        if db["n"] == 0:
            continue
        L = db["capacity"]
        tags = TagBlock(engine._bucket_ids(db, "pos"), *cols)
        if kernel == "affine_dp":
            args = (table, db["tokens"], db["lengths"], lt, gaps, "local")
            call = lambda m, tagged, a=args, tg=tags: m.affine_dp_scores(  # noqa: E731
                *a, tags=tg if tagged else None, len_t_host=len_ts)
            plain = lambda a=args, tg=tags: dp_kernels.affine_dp_scores_reference(  # noqa: E731
                *a, tags=tg)
            b, by = dp_bound_ms(db["tokens"], db["lengths"], lt, table, tags)
        else:
            args = (table, db["tokens"], db["lengths"], lt, *general.vecs(L), "local")
            host = general.host_vecs(L)
            call = lambda m, tagged, a=args, h=host, tg=tags: m.wsb_dp_scores(  # noqa: E731
                *a, host_costs=h, tags=tg if tagged else None)
            plain = lambda a=args, tg=tags: dp_kernels.wsb_dp_scores_reference(  # noqa: E731
                *a, tags=tg)
            b, by = wsb_bound_ms(db["tokens"], db["lengths"], lt, table, tags)
        worst = max(worst, _check_equal(kernel + "[tagged]", call(dp_kernels, True), plain(),
                                        "4e main-path shapes"))
        t = tag_turns(call, 5)
        for key, v in t.items():
            if key != "turns":
                times[key] = times.get(key, 0.0) + v
        plain_ms += cuda_ms(plain, 1)
        bound += b
        shapes.append([int(db["n"]), L, Tpad, len(qs)])
    return worst, times, plain_ms, bound, by, shapes


def phase_options(session, words, queries, finds, card):
    """4e: the query options on phase 4's session (1M slices) under the
    affine index and the general-gap one (ExponentialGapCost(3.0)): per
    option find_batch of the 32 queries and the 21 finds (``drive_option``)
    — tag weights (f32: they force it), token_filter + pos_filter and a
    Saliency(KeywordSignal) booster at int8, bf16 and f32, bidirectional
    (Q=32 becomes 64 in the pass) — with the wall times, alignments/s,
    extras rounds and Saliency.compile's time; a torch.profiler trace of
    the tag-weighted f32 batch; the tagged kernels held against their
    plain versions at the tag-weighted pass's shapes (Q=32 and a find's
    Q=1) and timed against their untagged selves.  Returns
    {"affine_dp[tagged]": ..., "wsb_dp[tagged]": ...} for the kernels'
    line."""
    from vectorian_tpu_torch.alignment import ExponentialGapCost

    n_slices = make_index(session).packed.n_slices
    out = {}
    for gap, kernel in ((None, "affine_dp"), (ExponentialGapCost(3.0), "wsb_dp")):
        for name, span_args, kw, precisions in _option_cases(words):
            index = make_index(session, gap, **span_args)
            if name == "booster":
                compile_s = []
                for _ in range(3):
                    t = time.perf_counter()
                    kw["booster"].compile(session, index.partition)
                    compile_s.append(time.perf_counter() - t)
            launches, per_prec, p50 = drive_option(index, queries, finds, kernel, name, kw,
                                                   precisions)
            for prec, m in per_prec.items():
                dt = sorted(m["times"])[1]
                emit({"phase": "options", "option": name, "kernel": kernel, "card": card,
                      "precision": prec, "slices": n_slices, "find_batch_Q": len(queries),
                      "find_batch_s": dt, "find_batch_s_all": m["times"],
                      "alignments_per_s": n_slices * len(queries) / dt,
                      "extras_rounds": m["extras_rounds"], "find_p50_ms": p50,
                      "launches": launches,
                      **({"saliency_compile_s": compile_s} if name == "booster" else {})})
            if name == "tag_weights":
                # where the tagged batch's time goes (PERF.md section 5)
                profile_calls(f"4e tag_weights {kernel} find_batch_Q{len(queries)}_float32",
                              lambda: index.find_batch(queries, n=10, min_score=0.2,
                                                       sim_precision="float32", **kw))
                res = {"launches": launches[kernel + "[tagged]"]}
                for sfx, qs in (("", queries), ("_find", finds[:1])):
                    err, times, plain_ms, bound, by, shapes = tagged_kernel_at_path(
                        index, qs, kernel)
                    res.update({"max_abs_err": max(err, res.get("max_abs_err", 0.0)),
                                **{k + sfx: v for k, v in times.items()},
                                f"plain_ms{sfx}": plain_ms, f"bound_ms{sfx}": bound,
                                f"bound_by{sfx}": by, f"shapes_n_L_Tpad_Q{sfx}": shapes})
                emit({"phase": "options_kernel", "name": kernel + "[tagged]", "card": card,
                      **res})
                out[kernel + "[tagged]"] = res
    return out


def _timed(fn):
    """(fn(), its CUDA-event ms)."""
    out = []
    ms = cuda_ms(lambda: out.append(fn()), 1)
    return out[0], ms


def long_query_profile(index, batch, n, min_score, counts=None, prefix="long_query"):
    """Where the long-query batch's time goes, at int8 (the default) and
    f32: a torch.profiler trace (device busy, idle share, top device
    events), then the host spans (utils/trace) of one more call, summed by
    name, beside its wall time and its launches by kernel and by route
    (``counts``: the kernel's route counts, the affine ones by default)."""
    import torch

    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.utils import trace

    counts = dp_kernels.AFFINE_ROUTE_LAUNCHES if counts is None else counts
    for prec in (None, "float32"):
        label = f"{prefix} find_batch Q={len(batch)} {prec or 'int8'}"

        def run():
            return index.find_batch(batch, n=n, min_score=min_score, sim_precision=prec)

        profile_calls(label, run)
        dp_kernels.reset_launches()
        trace.start()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        spans = {}
        for name, dt in trace.stop():
            ms, count = spans.get(name, (0.0, 0))
            spans[name] = (ms + dt * 1e3, count + 1)
        emit({"phase": f"{prefix}_spans", "call": label, "wall_ms": wall_ms,
              "spans_ms_count": {k: [ms, c] for k, (ms, c) in
                                 sorted(spans.items(), key=lambda kv: -kv[1][0])},
              "launches": {k: v for k, v in dp_kernels.LAUNCHES.items() if v},
              "routes": {k: v for k, v in counts.items() if v}})


def phase_long_query(session, long_q, queries, card):
    """4 (long queries): an affine find of a long query and a find_batch of
    32 queries that holds it (every needle padded to the long one's width)
    at each ranking precision on the 1M-slice packing, the launch counts
    set to 0 right before and read right after.  The batch's corpus pass
    splits by needle width: the 31 short needles must take the register
    route and the long one the register-resident wide route (wide_regs),
    as must the find; the shared-memory wide route must not launch.  The precisions
    and find must be byte-identical.  Then, at the shapes the path gave
    the kernels (the batch's Q=32 table of each type and the find's Q=1
    table): the whole batch's call (both launches and the split's copies),
    the same launches on the pass's prepared table (``affine_table``, made
    once a pass; these two held on WIDE_CUT slices a bucket) and the long
    needle's wide_regs launch alone, each held against its
    plain version and timed with its bound, the launch in turns against
    the shared-memory route on the same inputs (old, new, new, old); and where the
    batch's wall time goes at int8 and f32 (``long_query_profile``).
    Returns the kernels-line numbers of "affine_dp[wide]"."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.ops import dp_kernels, search
    from vectorian_tpu_torch.ops.search import scaled_costs, stack_query_tables

    index = make_index(session)
    batch = [long_q] + queries[:31]
    # the long needle aligns at most a sentence's 9 of its tokens: scores
    # stay under 9 / len(long_q)
    n, min_score = 10, 0.01
    real_round = search.BucketTopKSource.above_exact_many
    rounds = [0]

    def count_round(self, reqs):
        rounds[0] += 1
        return real_round(self, reqs)

    search.BucketTopKSource.above_exact_many = count_round
    try:
        # ---- the main path: launch counts from 0, read right after ----
        dp_kernels.reset_launches()
        t = time.perf_counter()
        single = pairs(index.find(long_q, n=n, min_score=min_score))
        find_s = time.perf_counter() - t
        find_routes = dict(dp_kernels.AFFINE_ROUTE_LAUNCHES)
        batches, times, extras = {}, {}, {"find": rounds[0]}
        for prec in PRECISIONS:
            r0 = rounds[0]
            t = time.perf_counter()
            batches[prec] = [pairs(r) for r in index.find_batch(
                batch, n=n, min_score=min_score, sim_precision=prec)]
            times[prec or "int8"] = time.perf_counter() - t
            extras[prec or "int8"] = rounds[0] - r0
        launches = dict(dp_kernels.LAUNCHES)
        routes = dict(dp_kernels.AFFINE_ROUTE_LAUNCHES)
        # ---- end of the main path ----
    finally:
        search.BucketTopKSource.above_exact_many = real_round
    wide = routes["wide_regs"]
    if (find_routes["wide_regs"] == 0 or find_routes["registers"] or wide <= find_routes["wide_regs"]
            or routes["registers"] == 0 or routes["wide_shared"] or routes["wide_scratch"]):
        raise AssertionError(f"long query: routes {routes} (find {find_routes}): the short "
                             "needles must take registers, the long one wide_regs")
    want = batches["float32"]
    for prec, b in batches.items():
        if b != want:
            raise AssertionError(f"long query: find_batch at {prec or 'int8'} differs from float32")
    shorts = [pairs(index.find(q, n=n, min_score=min_score)) for q in batch[1:4]]
    if [single] + shorts != want[:4]:
        raise AssertionError("long query: find and find_batch differ")
    if not single:
        raise AssertionError("long query: no matches")
    emit({"phase": "long_query", "card": card, "needle_tokens": len(long_q.split()),
          "slices": index.packed.n_slices, "find_s": find_s, "find_batch_Q": len(batch),
          "find_batch_s": times, "extras_rounds": extras, "wide_launches": wide,
          "affine_route_launches": routes, "find_route_launches": find_routes,
          "launches": {k: v for k, v in launches.items() if v},
          "precisions_and_find_byte_identical": True})
    long_query_profile(index, batch, n, min_score)

    dev = torch.device(DEVICE)
    res = {"launches": wide, "max_abs_err": 0.0, "launch_route": "wide_regs",
           "batch_plain_slices_a_bucket": WIDE_CUT}
    for key, qs, dt in (("", batch, None), ("[bf16]", batch, "bfloat16"),
                        ("[int8]", batch, "int8"), ("_find", [long_q], None)):
        _, plans, len_ts, _, _, _ = index._prepare_static_batch(qs, n, min_score, "float32", {})
        table, scale, _, Tpad = stack_query_tables(plans, len_ts, dt)
        gaps = scaled_costs(index._gaps, None, scale, Tpad, dev)[0]
        lt = torch.as_tensor(np.asarray(len_ts, np.int32), device=DEVICE)
        # the long needles' columns of the table: the wide_regs launch's input
        long_q_idx = [q for q, x in enumerate(len_ts) if x > dp_kernels.AFFINE_REG_MAX_T]
        qi = torch.as_tensor(long_q_idx, device=DEVICE)
        t_long, lt_long = table[..., qi].contiguous(), lt[qi]
        prepared = dp_kernels.affine_table(table, lt, len_ts)
        acc = {"ms": 0.0, "old_ms": 0.0, "turns": [], "plain_ms": 0.0, "bound": 0.0,
               "batch_ms": 0.0, "batch_launches_ms": 0.0, "batch_plain_ms": 0.0,
               "batch_bound": 0.0}
        for db in index._engine._device_buckets:
            tok, ln = db["tokens"], db["lengths"]
            whole = (table, tok, ln, lt, gaps, "local")
            part = (t_long, tok, ln, lt_long, gaps, "local")
            new = lambda: dp_kernels.affine_dp_scores(*part, _route="wide_regs")  # noqa: E731
            old = lambda: dp_kernels.affine_dp_scores(*part, _route="wide_shared")  # noqa: E731
            call = lambda: dp_kernels.affine_dp_scores(*whole, len_t_host=len_ts)  # noqa: E731
            launched = lambda: dp_kernels.affine_dp_scores(prepared, *whole[1:])  # noqa: E731
            # the whole batch's plain version on WIDE_CUT slices (~14 s at 1M)
            cut = (table, tok[:WIDE_CUT], ln[:WIDE_CUT], lt, gaps, "local")
            want_raw, p_ms = _timed(lambda: dp_kernels.affine_dp_scores_reference(*cut))
            for fn, label in (
                    (lambda: dp_kernels.affine_dp_scores(*cut, len_t_host=len_ts), ""),
                    (lambda: dp_kernels.affine_dp_scores(prepared, *cut[1:]), " prepared")):
                res["max_abs_err"] = max(res["max_abs_err"], _check_equal(
                    "affine_dp[wide]", fn(), want_raw, f"long-query shapes{key}{label}"))
            want_long, pl_ms = _timed(lambda: dp_kernels.affine_dp_scores_reference(*part))
            if not torch.equal(want_long[:WIDE_CUT], want_raw[:, qi]):
                raise AssertionError(f"long query{key}: the plain version of the long "
                                     "needle's columns differs from the batch's")
            for fn, label in ((new, "wide_regs"), (old, "wide_shared")):
                res["max_abs_err"] = max(res["max_abs_err"], _check_equal(
                    "affine_dp[wide]", fn(), want_long, f"long-query shapes{key} {label}"))
            if key in ("", "_find"):
                o_ms, n_ms, t = _turns(old, new, 3)
                acc["ms"] += n_ms
                acc["old_ms"] += o_ms
                acc["turns"].append(t)
                acc["plain_ms"] += pl_ms
                acc["bound"] += dp_bound_ms(tok, ln, lt_long, t_long)[0]
                acc["batch_ms"] += cuda_ms(call, 3)
                acc["batch_launches_ms"] += cuda_ms(launched, 3)
                acc["batch_plain_ms"] += p_ms
                acc["batch_bound"] += dp_bound_ms(tok, ln, lt, table)[0]
        if key in ("", "_find"):
            sfx = key
            res.update({f"ms{sfx}": acc["ms"], f"old_route_ms{sfx}": acc["old_ms"],
                        f"old_new_new_old_ms{sfx}": acc["turns"],
                        f"plain_ms{sfx}": acc["plain_ms"], f"bound_ms{sfx}": acc["bound"],
                        f"bound_by{sfx}": "operations",
                        f"batch_ms{sfx}": acc["batch_ms"],
                        f"batch_launches_ms{sfx}": acc["batch_launches_ms"],
                        f"batch_plain_ms{sfx}": acc["batch_plain_ms"],
                        f"batch_bound_ms{sfx}": acc["batch_bound"],
                        f"shapes_n_L_Tpad_Q{sfx}": [
                            [int(db["n"]), int(db["capacity"]), Tpad, len(long_q_idx)]
                            for db in index._engine._device_buckets]})
        del table, t_long, prepared
    emit({"phase": "long_query_kernel", "name": "affine_dp[wide]", **res})
    return res


# the slices of each bucket the old body and the plain versions run on at
# the general long query's shapes (the old body takes ~0.1 s a launch of
# 65,536 slices there, the plain version's scan a chunk of ~24,500
# slices at a time); the wide route runs the whole packing too
WIDE_CUT = 65_536


def _general_long_inputs(index, qs, dt):
    """The general-gap pass's inputs at the long query's shapes: queries
    ``qs`` at table type ``dt`` (None: f32) as ``find_batch`` stacks them.
    Returns (table, len_ts, len_t, GeneralGaps in the table's units, the
    wide needles' and the short needles' (columns, table, len_t) (None
    where a group is empty), the pass's ``WsbTable``)."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.search import scaled_costs, stack_query_tables

    dev = torch.device(DEVICE)
    _, plans, len_ts, _, _, _ = index._prepare_static_batch(qs, 10, 0.01, "float32", {})
    table, scale, _, Tpad = stack_query_tables(plans, len_ts, dt)
    general = scaled_costs(index._gaps, index._gap_costs, scale, Tpad, dev)[1]
    lt = torch.as_tensor(np.asarray(len_ts, np.int32), device=DEVICE)
    split = dp_kernels.needle_split(len_ts, Tpad, dp_kernels.WSB_REG_MAX_T)
    groups = []
    for sel, T in (((split.long, Tpad), (split.short, split.short_T)) if split
                   else ((list(range(len(qs))), Tpad), ([], 0))):
        if not sel:
            groups.append(None)
            continue
        qi = torch.as_tensor(sel, device=DEVICE)
        groups.append((qi, table[:, :T, qi].contiguous(), lt[qi]))
    return (table, len_ts, lt, general, *groups,
            dp_kernels.wsb_table(table, lt, len_ts))


def old_body_at_long_query(session, long_q, queries):
    """The old body (the thread-a-problem body kernel 3 took for a needle
    past 32 columns before the wide route) at the general long query's
    shapes on WIDE_CUT slices of each bucket, forced: the long needle's
    launch (a find's, and the wide group's of the Q = 32 batch at f32 and
    int8) and the whole batch at Tpad 160 (the one launch before the
    split); device ms, bound ms.  Prints one line a shape."""
    from vectorian_tpu_torch.alignment import ExponentialGapCost
    from vectorian_tpu_torch.ops import dp_kernels

    index = make_index(session, ExponentialGapCost(3.0))
    batch = [long_q] + queries[:31]
    for key, qs, dt in (("_find", [long_q], None), ("", batch, None), ("[int8]", batch, "int8")):
        table, _, lt, general, wide, _, _ = _general_long_inputs(index, qs, dt)
        Tpad = int(table.shape[1])
        for db in index._engine._device_buckets:
            L, tok, ln = int(db["capacity"]), db["tokens"][:WIDE_CUT], db["lengths"][:WIDE_CUT]
            vecs, host = general.vecs(L), general.host_vecs(L)
            cases = [("wide_group", wide[1], wide[2])]
            if len(qs) > 1:
                cases.append(("whole_batch", table, lt))
            for label, t, ltq in cases:
                Q = int(t.shape[2])
                old = dp_kernels.wsb_launch_plan(tok.shape[0] * Q, L, Tpad, registers=False,
                                                 wide=False).route
                run = (lambda t=t, ltq=ltq, old=old: dp_kernels.wsb_dp_scores(
                    t, tok, ln, ltq, *vecs, "local", host_costs=host, _route=old))
                bound, by = wsb_bound_ms(tok, ln, ltq, t)
                emit({"phase": "long_query_general_old_body", "shape": key, "launch": label,
                      "slices": int(tok.shape[0]), "L": L, "Tpad": Tpad, "Q": Q,
                      "table": str(t.dtype).replace("torch.", ""), "old_route": old,
                      "old_ms": device_ms(run, _turn_reps({"r": run})), "bound_ms": bound,
                      "bound_by": by})


def phase_long_query_general(session, long_q, queries, card):
    """4 (long queries, general gaps): a ``LocalAlignment(ExponentialGapCost(
    3.0))`` find of phase 4's 160-token query and a find_batch of 32
    queries that holds it (every needle padded to 160) at each ranking
    precision on the 1M-slice packing, the launch counts set to 0 right
    before and read right after: the batch's pass splits by needle width,
    so its 31 short needles must take the register route and the long one
    the wide route (as the find does); the thread-a-problem body (shared,
    scratch) must not launch, nor the long route.  The precisions and find
    must be byte-identical.  Then the long query's ``find`` p50 (5 more),
    a torch.profiler trace of its int8 and f32 batches
    (``long_query_profile``), and, at the shapes the path gave the kernel
    (the batch's Q=32 table at f32, int8 and bf16, and the find's Q=1):
    each group's launch held bit for bit against its plain version and the
    pass's launches (``wsb_table``) against both on WIDE_CUT slices of each
    bucket; on that cut the wide launch in turns against the old body
    forced, and the pass's launches against the whole batch on the old
    body (the one launch before the split); on the whole packing the wide
    launch, the short group's and the pass's, each beside its bound.
    Returns the kernels-line numbers of "wsb_dp[wide]"."""
    import numpy as np

    from vectorian_tpu_torch.alignment import ExponentialGapCost
    from vectorian_tpu_torch.ops import dp_kernels, search

    index = make_index(session, ExponentialGapCost(3.0))
    batch = [long_q] + queries[:31]
    n, min_score = 10, 0.01
    real_round = search.BucketTopKSource.above_exact_many
    rounds = [0]

    def count_round(self, reqs):
        rounds[0] += 1
        return real_round(self, reqs)

    search.BucketTopKSource.above_exact_many = count_round
    try:
        # ---- the main path: launch counts from 0, read right after ----
        dp_kernels.reset_launches()
        t = time.perf_counter()
        single = pairs(index.find(long_q, n=n, min_score=min_score))
        find_s = time.perf_counter() - t
        find_routes = dict(dp_kernels.WSB_ROUTE_LAUNCHES)
        batches, times, extras = {}, {}, {"find": rounds[0]}
        for prec in PRECISIONS:
            r0 = rounds[0]
            t = time.perf_counter()
            batches[prec] = [pairs(r) for r in index.find_batch(
                batch, n=n, min_score=min_score, sim_precision=prec)]
            times[prec or "int8"] = time.perf_counter() - t
            extras[prec or "int8"] = rounds[0] - r0
        launches = dict(dp_kernels.LAUNCHES)
        routes = dict(dp_kernels.WSB_ROUTE_LAUNCHES)
        # ---- end of the main path ----
    finally:
        search.BucketTopKSource.above_exact_many = real_round
    wide = routes["wide"]
    old = {r: v for r, v in routes.items()
           if v and r.removeprefix("rows_") in ("shared", "scratch", "long")}
    if (find_routes["wide"] == 0 or find_routes["registers"] or wide <= find_routes["wide"]
            or routes["registers"] == 0 or old):
        raise AssertionError(f"general long query: routes {routes} (find {find_routes}): "
                             "the short needles must take registers, the long one wide")
    want = batches["float32"]
    for prec, b in batches.items():
        if b != want:
            raise AssertionError(f"general long query: find_batch at {prec or 'int8'} "
                                 "differs from float32")
    shorts = [pairs(index.find(q, n=n, min_score=min_score)) for q in batch[1:4]]
    if [single] + shorts != want[:4]:
        raise AssertionError("general long query: find and find_batch differ")
    if not single:
        raise AssertionError("general long query: no matches")
    p50 = []
    for _ in range(5):
        t = time.perf_counter()
        if pairs(index.find(long_q, n=n, min_score=min_score)) != single:
            raise AssertionError("general long query: find differs between calls")
        p50.append(time.perf_counter() - t)
    emit({"phase": "long_query_general", "card": card, "needle_tokens": len(long_q.split()),
          "slices": index.packed.n_slices, "first_find_s": find_s,
          "find_p50_ms": float(np.median(p50)) * 1e3, "find_batch_Q": len(batch),
          "find_batch_s": times, "extras_rounds": extras, "wide_launches": wide,
          "wsb_route_launches": {k: v for k, v in routes.items() if v},
          "find_route_launches": {k: v for k, v in find_routes.items() if v},
          "launches": {k: v for k, v in launches.items() if v},
          "precisions_and_find_byte_identical": True})
    long_query_profile(index, batch, n, min_score, dp_kernels.WSB_ROUTE_LAUNCHES,
                       "long_query_general")

    res = {"launches": wide, "max_abs_err": 0.0, "launch_route": "wide",
           "find_p50_ms": float(np.median(p50)) * 1e3,
           "find_batch_ms": {k: v * 1e3 for k, v in times.items()}}
    for key, qs, dt in (("", batch, None), ("[int8]", batch, "int8"),
                        ("[bf16]", batch, "bfloat16"), ("_find", [long_q], None)):
        table, len_ts, lt, general, wide_g, short_g, prepared = _general_long_inputs(
            index, qs, dt)
        Tpad = int(table.shape[1])
        acc = {}

        def add(k, v):
            acc[k] = acc.get(k, 0.0) + v

        for db in index._engine._device_buckets:
            L, tok, ln = int(db["capacity"]), db["tokens"], db["lengths"]
            tok_c, ln_c = tok[:WIDE_CUT], ln[:WIDE_CUT]
            vecs, host = general.vecs(L), general.host_vecs(L)
            qi, t_wide, lt_wide = wide_g
            plain_wide, p_ms = _timed_plain(lambda: dp_kernels.wsb_dp_scores_reference(
                t_wide, tok_c, ln_c, lt_wide, *vecs, "local"))
            want_c = plain_wide
            if short_g is not None:
                qs_i, t_short, lt_short = short_g
                plain_short, ps_ms = _timed_plain(lambda: dp_kernels.wsb_dp_scores_reference(
                    t_short, tok_c, ln_c, lt_short, *vecs, "local"))
                want_c = plain_wide.new_empty((tok_c.shape[0], len(qs)))
                want_c[:, qi], want_c[:, qs_i] = plain_wide, plain_short
                add("plain_ms_short", ps_ms)
            add("plain_ms", p_ms)

            def wide_at(tk, lnk, route="wide"):
                return lambda: dp_kernels.wsb_dp_scores(t_wide, tk, lnk, lt_wide, *vecs, "local",
                                                        host_costs=host, _route=route)

            def pass_at(tk, lnk):
                return lambda: dp_kernels.wsb_dp_scores(prepared, tk, lnk, lt, *vecs, "local",
                                                        host_costs=host)

            label = f"general long-query shapes{key}, bucket {L}"
            res["max_abs_err"] = max(
                res["max_abs_err"],
                _check_equal("wsb_dp[wide]", _with_route(wide_at(tok_c, ln_c))[0], plain_wide,
                             label + " wide"),
                _check_equal("wsb_dp[wide]", pass_at(tok_c, ln_c)(), want_c, label + " pass"))
            old = dp_kernels.wsb_launch_plan(tok_c.shape[0] * len(qi), L, Tpad, registers=False,
                                             wide=False).route
            _check_equal("wsb_dp old body", wide_at(tok_c, ln_c, old)(), plain_wide, label)
            if key == "[bf16]":
                continue
            runs = {"wide": wide_at(tok_c, ln_c), old: wide_at(tok_c, ln_c, old)}
            means, turns = device_turns(runs, _turn_reps(runs))
            add("ms_cut", means["wide"])
            add("old_ms_cut", means[old])
            add("bound_ms_cut", wsb_bound_ms(tok_c, ln_c, lt_wide, t_wide)[0])
            acc.setdefault("turns_cut", []).append(turns)
            full = wide_at(tok, ln)
            add("ms", device_ms(full, _turn_reps({"r": full}, 100.0)))
            add("bound_ms", wsb_bound_ms(tok, ln, lt_wide, t_wide)[0])
            if short_g is not None:
                short = (lambda: dp_kernels.wsb_dp_scores(
                    t_short, tok, ln, lt_short, *vecs, "local", host_costs=host))
                if _with_route(short)[1] != "registers":
                    raise AssertionError(f"{label}: the short group left the register route")
                add("short_ms", device_ms(short, _turn_reps({"r": short}, 100.0)))
                add("short_bound_ms", wsb_bound_ms(tok, ln, lt_short, t_short)[0])
                whole = pass_at(tok, ln)
                add("pass_ms", device_ms(whole, _turn_reps({"r": whole}, 100.0)))
                add("pass_bound_ms", wsb_bound_ms(tok, ln, lt, table)[0])
                # the whole batch on the old body (its one launch before the
                # split) against the pass's launches, on the cut
                old_whole = dp_kernels.wsb_launch_plan(tok_c.shape[0] * len(qs), L, Tpad,
                                                       registers=False, wide=False).route
                runs = {"pass": pass_at(tok_c, ln_c),
                        old_whole: lambda: dp_kernels.wsb_dp_scores(
                            table, tok_c, ln_c, lt, *vecs, "local", host_costs=host,
                            _route=old_whole)}
                _check_equal("wsb_dp old body", runs[old_whole](), want_c, label + " whole")
                means, turns = device_turns(runs, _turn_reps(runs))
                add("pass_ms_cut", means["pass"])
                add("old_pass_ms_cut", means[old_whole])
                acc.setdefault("pass_turns_cut", []).append(turns)
        shapes = [[int(db["n"]), int(db["capacity"]), Tpad, len(wide_g[0])]
                  for db in index._engine._device_buckets]
        res.update({f"{k}{key}": v for k, v in acc.items()})
        res[f"shapes_n_L_Tpad_Q{key}"] = shapes
        emit({"phase": "long_query_general_kernel", "shape": key or "Q32", "card": card,
              "cut_slices": WIDE_CUT, **acc, "shapes_n_L_Tpad_Q": shapes})
        del table, prepared, wide_g, short_g
    res["bound_by"] = "operations"
    return res


# BASELINE config 1's fastText: cc.en.300.bin's arguments (fasttext.cc, "Word
# vectors for 157 languages": dim 300, character n-grams of length 5,
# 2,000,000 buckets); its dictionary is cut to the phase-4 corpus's 2,500
# most frequent words (rows no lookup reads), so the input matrix is
# (2,500 + 2,000,000) x 300 f32 = 2.40 GB
FT_DIM, FT_MINN, FT_MAXN, FT_BUCKET, FT_DICT = 300, 5, 5, 2_000_000, 2_500


def fasttext_model(texts, rng, tmp):
    """4d's model: the .bin written from the seeded ``rng`` into the
    directory ``tmp`` and loaded through PretrainedFastText; returns (the
    embedding, {"write_s", "load_s", "bin_bytes", "dictionary"})."""
    import collections

    import numpy as np

    import vectorian_tpu_torch as vt
    from vectorian_tpu_torch.embedding.fasttext import FastTextModel

    counts = collections.Counter(w.rstrip(".") for t in texts for w in t.split())
    top = [w for w, _ in counts.most_common(FT_DICT)]
    path = Path(tmp) / "cc.en.300.bin"
    t = time.perf_counter()
    mat = rng.standard_normal((len(top) + FT_BUCKET, FT_DIM), dtype=np.float32)
    FastTextModel(top, len(top), FT_DIM, FT_BUCKET, FT_MINN, FT_MAXN, mat).save(path)
    del mat
    write_s = time.perf_counter() - t
    ft = vt.PretrainedFastText("en", path=str(path))
    t = time.perf_counter()
    model = ft.model
    load_s = time.perf_counter() - t
    if (model.dim, model.bucket, model.minn, model.maxn, model.nwords) != (
            FT_DIM, FT_BUCKET, FT_MINN, FT_MAXN, FT_DICT):
        raise AssertionError("fastText .bin: wrong arguments after loading")
    return ft, {"write_s": write_s, "load_s": load_s, "bin_bytes": path.stat().st_size,
                "dictionary": len(top)}


def oov_words(rng, k):
    """``k`` alphabetic words outside the corpus's ("w" + letters)."""
    return ["z" + "".join(chr(97 + int(c)) for c in rng.integers(0, 26, size=6))
            for _ in range(k)]


def phase_fasttext(session, ft, queries, finds, rng, card, info):
    """4d: BASELINE config 1 on the phase-4 session — fastText 300d (the
    session's second embedding) and local alignment with affine gaps.  Each
    query and find holds 2 words outside the corpus, which get vectors from
    their n-grams.  The vocabulary's encode is timed on its own; find
    p50 over the finds and find_batch Q=32 at the default precision (three
    warm calls), launch counts set to 0 right before and read right after;
    find_batch at the default precision and at float32 and find must be
    byte-identical."""
    import numpy as np

    from vectorian_tpu_torch.alignment import AffineGapCost, LocalAlignment
    from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim
    from vectorian_tpu_torch.ops import dp_kernels

    def with_oov(q):
        w = q.split()
        a, b = oov_words(rng, 2)
        return " ".join(w[:2] + [a] + w[2:5] + [b] + w[5:])

    queries, finds = [with_oov(q) for q in queries], [with_oov(q) for q in finds]
    vocab = list(session.vocab.tokens.strings)
    t = time.perf_counter()
    ft.create_encoder().encode_tokens(vocab)
    encode_s = time.perf_counter() - t
    index = session.partition("sentence").index(OptimizedSpanSim(
        EmbeddingTokenSim(ft), LocalAlignment(AffineGapCost(0.37, 0.113))))
    n, min_score = 10, 0.2
    # ---- the main path: launch counts from 0, read right after ----
    dp_kernels.reset_launches()
    first = [pairs(r) for r in index.find_batch(queries, n=n, min_score=min_score)]
    lats, singles = [], []
    for q in finds:
        t = time.perf_counter()
        singles.append(pairs(index.find(q, n=n, min_score=min_score)))
        lats.append(time.perf_counter() - t)
    times = []
    for _ in range(3):
        t = time.perf_counter()
        batch = [pairs(r) for r in index.find_batch(queries, n=n, min_score=min_score)]
        times.append(time.perf_counter() - t)
    launches = dict(dp_kernels.LAUNCHES)
    # ---- end of the main path ----
    if launches["affine_dp[int8]"] == 0 or launches["affine_dp"] < len(finds):
        raise AssertionError(f"fastText: the affine kernel did not serve the path: {launches}")
    f32 = [pairs(r) for r in index.find_batch(queries, n=n, min_score=min_score,
                                              sim_precision="float32")]
    if batch != first or f32 != first:
        raise AssertionError("fastText: find_batch differs between calls or precisions")
    if [pairs(index.find(q, n=n, min_score=min_score)) for q in queries[:8]] != first[:8]:
        raise AssertionError("fastText: find and find_batch differ")
    if not any(first) or not any(singles):
        raise AssertionError("fastText: no matches at all")
    n_slices = index.packed.n_slices
    dt = float(np.median(times))
    emit({"phase": "fasttext", "card": card, **info, "vocab_encode_s": encode_s,
          "vocab": len(vocab), "dim": FT_DIM, "bucket": FT_BUCKET, "minn": FT_MINN,
          "maxn": FT_MAXN, "slices": n_slices, "find_p50_ms": float(np.percentile(
              np.asarray(lats) * 1e3, 50)), "find_batch_Q": len(queries),
          "find_batch_s": dt, "find_batch_s_all": times,
          "alignments_per_s": n_slices * len(queries) / dt,
          "launches": {k: v for k, v in launches.items() if v},
          "default_f32_and_find_byte_identical": True})


def phase_warmup(session, query, card):
    """``index.warmup()`` on a new index of the 1M-slice session once the
    kernels are built, then a first find; neither may run a compiler (every
    build goes through subprocess.run, which is counted)."""
    import subprocess

    index = make_index(session)
    runs = []
    real = subprocess.run

    def counting(*args, **kwargs):
        runs.append(args[0][0] if args else kwargs.get("args"))
        return real(*args, **kwargs)

    subprocess.run = counting
    try:
        t = time.perf_counter()
        index.warmup(max_tokens=12, n=10)
        warm_s = time.perf_counter() - t
        during = len(runs)
        t = time.perf_counter()
        r = index.find(query, n=10, min_score=0.2)
        first_s = time.perf_counter() - t
    finally:
        subprocess.run = real
    if runs:
        raise AssertionError(f"warmup: a compiler ran: {runs}")
    check_results([r], 10, 0.2)
    emit({"phase": "warmup", "card": card, "warmup_s": warm_s, "builds_during_warmup": during,
          "first_find_ms": first_s * 1e3, "builds_during_first_find": len(runs) - during})


def phase_packed_cache(session, queries, card):
    """The packed-corpus cache on the 1M-slice session: the packing saved
    cold (packed and written) and loaded on a hit, each timed, under a
    VECTORIAN_CACHE_HOME of this run's own; an index over the loaded
    packing must return the same matches as before."""
    from vectorian_tpu_torch.embedding.static import cache_home

    spec = session.partition("sentence").spec
    n, min_score = 10, 0.2
    want = [pairs(r) for r in make_index(session).find_batch(
        queries, n=n, min_score=min_score, sim_precision="float32")]
    cdir = cache_home() / "packed"
    for f in cdir.glob("*.npz"):
        f.unlink()
    t = time.perf_counter()
    session._load_or_pack(spec)
    cold_s = time.perf_counter() - t
    files = list(cdir.glob("*.npz"))
    session._packed_cache.clear()
    session._engine_cache.clear()
    t = time.perf_counter()
    packed = session.packed_corpus(spec)
    hit_s = time.perf_counter() - t
    got = [pairs(r) for r in make_index(session).find_batch(
        queries, n=n, min_score=min_score, sim_precision="float32")]
    if len(files) != 1 or got != want:
        raise AssertionError("packed cache: the loaded packing gives other matches")
    emit({"phase": "packed_cache", "card": card, "slices": packed.n_slices,
          "cold_pack_and_save_s": cold_s, "hit_load_s": hit_s,
          "file_bytes": files[0].stat().st_size, "same_matches": True})


def compare_with_cpu(label, a, b):
    """Card results ``a`` against CPU results ``b``: the same matches, the
    scores within 1e-6 relative (the [V, T] GEMM sums in another order on
    the card), ids swapped only inside that tolerance."""
    worst = 0.0
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            raise AssertionError(f"{label}: card and CPU return different match counts")
        for (ia, sa), (ib, sb) in zip(ra, rb):
            err = abs(sa - sb)
            worst = max(worst, err)
            if err > 1e-6 * max(1.0, abs(sb)) or (ia != ib and err > 1e-6):
                raise AssertionError(f"{label}: card {ra} != CPU {rb}")
    return worst


def duplicates_corpus(rng):
    """3,000 sentences of the Zipf vocabulary, 1,400 of them copies of two
    sentences: every query near them ties far past the fused top-k's deep
    fetch, so its cut is unsafe and the extras round runs."""
    words, _, query = zipf_corpus(2_000, rng)
    a = " ".join(words[i] for i in (3, 17, 5, 40, 8, 2, 99, 11, 6))
    b = " ".join(words[i] for i in (7, 1, 13, 4, 250, 9, 12, 0, 31))
    sents = [a] * 700 + [b] * 700 + [query() for _ in range(1_600)]
    rng.shuffle(sents)
    texts = [". ".join(sents[i : i + 500]) + "." for i in range(0, len(sents), 500)]
    queries = [a, b, " ".join(a.split()[:5]), " ".join(b.split()[2:])] + [
        query() for _ in range(8)]
    return words, texts, queries


def _wide_launches(rows=False):
    """Launches of the affine wide routes (registers, or rows in shared
    memory or scratch) since the counts' last reset."""
    from vectorian_tpu_torch.ops import dp_kernels

    p = "rows_" if rows else ""
    return sum(dp_kernels.AFFINE_ROUTE_LAUNCHES[p + r]
               for r in ("wide_regs", "wide_shared", "wide_scratch"))


def phase_rescore(card):
    """4c: the finalizer's score-only rescore on the card (the row-gather
    kernels) under an affine and a general-gap index, against the port on
    the CPU, and (affine) a long query — sentence A repeated 15 times, 135
    tokens, padded to 136 — whose extras round takes the row-gather entry's
    wide route; returns per kernel ("affine_dp_flat[wide]" for the long
    query) its launches, the extras rounds, the calls (round, args, kwargs)
    and the routes the path gave it."""
    import numpy as np

    from vectorian_tpu_torch.alignment import ExponentialGapCost
    from vectorian_tpu_torch.ops import dp_kernels, search

    rng = np.random.default_rng(SEED + 3)
    words, texts, queries = duplicates_corpus(rng)
    vectors = rng.normal(size=(len(words), 300)).astype(np.float32)
    on_card = build_session(texts, words, vectors, DEVICE)
    on_cpu = build_session(texts, words, vectors, "cpu")
    real_round = search.BucketTopKSource.above_exact_many
    out = {}
    long_q = " ".join([queries[0]] * 15)
    exp = ExponentialGapCost(3.0)
    for kernel, wrapper, gap, finds, batch, min_score, span in (
        ("affine_dp_flat", "affine_dp_scores_rows", None, queries[:4], queries, 0.1, {}),
        ("wsb_dp_flat", "wsb_dp_scores_rows", exp, queries[:4], queries, 0.1, {}),
        ("affine_dp_flat[wide]", "affine_dp_scores_rows", None, [long_q],
         [long_q] + queries[:3], 0.0, {}),
        # the tag-weighted rows of an index with tag weights (4e's)
        ("affine_dp_flat[tagged]", "affine_dp_scores_rows", None, queries[:4], queries,
         0.1, TAG_ARGS),
        ("wsb_dp_flat[tagged]", "wsb_dp_scores_rows", exp, queries[:4], queries, 0.1,
         TAG_ARGS),
    ):
        idx_card, idx_cpu = make_index(on_card, gap, **span), make_index(on_cpu, gap, **span)
        real = getattr(search, wrapper)
        seen, rounds = [], [0]

        def record(*args, real=real, seen=seen, rounds=rounds, **kwargs):
            seen.append((rounds[0], args, kwargs))
            return real(*args, **kwargs)

        def count_round(self, reqs, rounds=rounds):
            rounds[0] += 1
            return real_round(self, reqs)

        n = 10
        setattr(search, wrapper, record)
        search.BucketTopKSource.above_exact_many = count_round
        try:
            # ---- the main path: launch counts from 0, read right after ----
            dp_kernels.reset_launches()
            got_f = [pairs(idx_card.find(q, n=n, min_score=min_score)) for q in finds]
            got_b = [pairs(r) for r in idx_card.find_batch(batch, n=n, min_score=min_score)]
            if kernel.endswith("[wide]"):
                launches = _wide_launches(rows=True)
                routes = {k: v for k, v in dp_kernels.AFFINE_ROUTE_LAUNCHES.items() if v}
            else:
                launches = dp_kernels.LAUNCHES[kernel]
                routes = {k: v for k, v in dp_kernels.WSB_ROUTE_LAUNCHES.items() if v}
            # ---- end of the main path ----
        finally:
            setattr(search, wrapper, real)
            search.BucketTopKSource.above_exact_many = real_round
        if launches == 0:
            raise AssertionError(f"rescore: the extras round launched no {kernel} kernel")
        want_f = [pairs(idx_cpu.find(q, n=n, min_score=min_score)) for q in finds]
        want_b = [pairs(r) for r in idx_cpu.find_batch(batch, n=n, min_score=min_score)]
        worst = max(compare_with_cpu(f"rescore {kernel}", got_f, want_f),
                    compare_with_cpu(f"rescore {kernel}", got_b, want_b))
        if got_b[:len(finds)] != got_f:
            raise AssertionError(f"rescore {kernel}: find and find_batch differ")
        per_round = [sum(1 for r, _, _ in seen if r == i) for i in range(1, rounds[0] + 1)]
        emit({"phase": "rescore", "kernel": kernel, "launches": launches,
              "rounds": rounds[0], "launches_per_round": per_round,
              "calls": len(seen), "route_launches": routes,
              "needle_tokens": [len(q.split()) for q in batch][:2],
              "problems_per_call": [int(a[1].shape[0]) for _, a, _ in seen],
              "max_abs_score_diff_vs_cpu": worst, "card": card})
        if max(per_round, default=0) > len(idx_card.packed.buckets):
            raise AssertionError(f"rescore {kernel}: more than one launch a bucket a round")
        out[kernel] = {"launches": launches, "rounds": rounds[0],
                       "per_round": per_round, "calls": seen,
                       "routes": sorted(routes)}
    return out


def time_tagged_row_calls(kernel, res):
    """A tagged row-gather kernel at the inputs 4c's tag-weighted extras
    rounds gave it: held against its plain version, timed on the device
    against the same call without tags in turns (``tag_turns``; with
    ``--old-tree`` the parent's design too), and its bound.  Returns (max
    |diff|, {"ms", "untagged_ms", "host_ms"[, "old_ms",
    "old_untagged_ms"]} summed over the calls, plain ms, bound ms,
    bound_by)."""
    from vectorian_tpu_torch.ops import dp_kernels

    entry = "wsb_dp_scores_rows" if kernel.startswith("wsb") else "affine_dp_scores_rows"
    plain = getattr(dp_kernels, entry + "_reference")
    worst = plain_ms = bound = 0.0
    times = {}
    by = "operations"
    for _, args, kwargs in res["calls"]:
        tags = kwargs["tags"]
        untagged = {k: v for k, v in kwargs.items() if k != "tags"}

        def call(m, tagged, args=args, kwargs=kwargs, untagged=untagged):
            return getattr(m, entry)(*args, **(kwargs if tagged else untagged))

        worst = max(worst, _check_equal(kernel, call(dp_kernels, True),
                                        plain(*args, tags=tags), "main-path shapes"))
        for key, v in tag_turns(call, 10).items():
            if key != "turns":
                times[key] = times.get(key, 0.0) + v
        plain_ms += cuda_ms(lambda: plain(*args, tags=tags), 1)
        b, by = rows_bound_ms(kernel, *args[:7], tags=tags)
        bound += b
    return worst, times, plain_ms, bound, by


def _per_column_call(kernel, args, kwargs, sel):
    """The form a row-gather call replaced, for the problems ``sel`` of one
    query column: gather the column's similarity block, then the
    flat-batch entry (WSB on its one-thread-a-problem route) and the
    empty-slice mask."""
    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.search import NEG_SCORE, _mq_similarity

    tokens, rows, qslot, table, V, len_s, len_t, *rest = args
    r, q, ln, lt = rows[sel], qslot[sel], len_s[sel], len_t[sel]
    if kernel.startswith("affine_dp_flat"):
        return lambda: dp_kernels.affine_dp_scores_flat(
            _mq_similarity(tokens[r.long()], q, table, V), ln, lt, *rest
        ).masked_fill(ln <= 0, NEG_SCORE)
    old = dp_kernels.wsb_launch_plan(len(sel), tokens.shape[1], table.shape[1],
                                     registers=False).route
    return lambda: dp_kernels.wsb_dp_scores_flat(
        _mq_similarity(tokens[r.long()], q, table, V), ln, lt, *rest,
        host_costs=kwargs.get("host_costs"), _route=old,
    ).masked_fill(ln <= 0, NEG_SCORE)


def time_row_calls(kernel, res):
    """Kernel vs plain on the card at the inputs the main path gave a
    row-gather kernel, and each extras round's device ms against the
    per-column gather + flat-batch form it replaced (one call a column,
    held bit for bit against the kernel).  Returns (max |diff|, ms, plain
    ms, bound ms, bound_by, per-round ms, per-round ms before, columns a
    round)."""
    import torch

    from vectorian_tpu_torch.ops import dp_kernels

    entry = "wsb_dp_scores_rows" if kernel == "wsb_dp_flat" else "affine_dp_scores_rows"
    base = kernel.split("[")[0]
    run = getattr(dp_kernels, entry)
    plain = getattr(dp_kernels, entry + "_reference")
    worst = ms = plain_ms = bound = 0.0
    by = "operations"
    after = [0.0] * res["rounds"]
    before = [0.0] * res["rounds"]
    q_after = [0.0] * res["rounds"]
    q_before = [0.0] * res["rounds"]
    columns = [0] * res["rounds"]
    for rnd, args, kwargs in res["calls"]:
        got = run(*args, **kwargs)
        worst = max(worst, _check_equal(kernel, got, plain(*args), "main-path shapes"))
        t = cuda_ms(lambda: run(*args, **kwargs), 20)
        q_t = device_ms(lambda: run(*args, **kwargs), 20)
        ms += t
        plain_ms += cuda_ms(lambda: plain(*args), 1)
        b, by = rows_bound_ms(base, *args[:7])
        bound += b
        qslot = args[2]
        t_cols = q_cols = 0.0
        for q in sorted(set(qslot.tolist())):
            sel = torch.nonzero(qslot == q).flatten()
            col = _per_column_call(kernel, args, kwargs, sel)
            _check_equal(kernel, got[sel], col(), "per-column form")
            t_cols += cuda_ms(col, 20)
            q_cols += device_ms(col, 20)
            if rnd:
                columns[rnd - 1] += 1
        if rnd:
            after[rnd - 1] += t
            before[rnd - 1] += t_cols
            q_after[rnd - 1] += q_t
            q_before[rnd - 1] += q_cols
    emit({"phase": "rescore_rounds", "kernel": kernel,
          "launches_per_round": res["per_round"], "columns_per_round": columns,
          "round_ms": after, "round_ms_before": before,
          "sum_ms": sum(after), "sum_ms_before": sum(before),
          "queued_round_ms": q_after, "queued_round_ms_before": q_before,
          "queued_sum_ms": sum(q_after), "queued_sum_ms_before": sum(q_before)})
    return worst, ms, plain_ms, bound, by, after, before, columns, q_after, q_before


def phase_submatch_debug(session, queries, finds, card):
    """4g, on phase 4's session: submatch_weight=0.5 through find (the
    full-read score_topk branch; p50 of the 21 finds) and find_batch (Q=32,
    the fused branch's 4n + 32 overfetch; median of 3), affine and general
    gaps, find = find_batch byte for byte on 4 queries; one find with a
    debug callback counting its hooks by name; one boosted submatch find.
    The launch counts are set to 0 right before each run and read right
    after."""
    import numpy as np

    import vectorian_tpu_torch as vt
    from vectorian_tpu_torch.alignment import ExponentialGapCost
    from vectorian_tpu_torch.ops import dp_kernels

    out = {}
    for label, gap in (("affine", None), ("general", ExponentialGapCost(3.0))):
        index = make_index(session, gap)
        kw = {"n": 10, "min_score": 0.2, "submatch_weight": 0.5}
        index.find(finds[0], **kw)  # warm
        dp_kernels.reset_launches()
        ts, got = [], []
        for q in finds:
            t = time.perf_counter()
            got.append(pairs(index.find(q, **kw)))
            ts.append((time.perf_counter() - t) * 1e3)
        find_launches = {k: v for k, v in dp_kernels.LAUNCHES.items() if v}
        dp_kernels.reset_launches()
        walls, res = [], None
        for _ in range(3):
            t = time.perf_counter()
            res = index.find_batch(queries, **kw)
            walls.append((time.perf_counter() - t) * 1e3)
        batch_launches = {k: v for k, v in dp_kernels.LAUNCHES.items() if v}
        check_results(res, 10, -1e30)
        if [pairs(r) for r in res[:4]] != [pairs(index.find(q, **kw)) for q in queries[:4]]:
            raise AssertionError(f"4g {label}: submatch find and find_batch differ")
        if not any(got) or not find_launches or not batch_launches:
            raise AssertionError(f"4g {label}: no matches or no kernel launch")
        out[label] = {"find_p50_ms": float(np.median(ts)), "find_launches": find_launches,
                      "find_batch_ms_median": float(np.median(walls)),
                      "find_batch_ms": walls, "find_batch_launches": batch_launches}
    index = make_index(session)
    hooks = {}
    dp_kernels.reset_launches()
    t = time.perf_counter()
    r = index.find(finds[1], n=10, min_score=0.2,
                   debug=lambda name, payload: hooks.__setitem__(name, hooks.get(name, 0) + 1))
    debug_ms = (time.perf_counter() - t) * 1e3
    if not {"static_similarity_matrix", "scores", "document/match_time", "alignment"} <= set(hooks):
        raise AssertionError(f"4g: debug hooks {hooks}")
    if pairs(r) != pairs(index.find(finds[1], n=10, min_score=0.2)):
        raise AssertionError("4g: debug changed the result")
    sal = vt.Saliency(0.6).add_signal(vt.KeywordSignal(finds[2].split()[0]), 1.0)
    t = time.perf_counter()
    rb = index.find(finds[2], n=10, min_score=0.2, submatch_weight=0.5, booster=sal)
    boosted_ms = (time.perf_counter() - t) * 1e3
    sb = [m.score for m in rb]
    if not sb or sb != sorted(sb, reverse=True) or not all(map(math.isfinite, sb)):
        raise AssertionError(f"4g: boosted submatch scores {sb}")
    emit({"phase": "submatch_debug", "slices": index.packed.n_slices, "queries": len(queries),
          "finds": len(finds), "submatch_weight": 0.5, **out, "debug_hooks": hooks,
          "debug_find_ms": debug_ms, "debug_launches": {
              k: v for k, v in dp_kernels.LAUNCHES.items() if v},
          "boosted_submatch_find_ms": boosted_ms, "card": card})
    return out


def _ctx_embedding(words, rng):
    """A LambdaContextualEmbedding of CTX_DIM: each word a seeded numpy
    vector, each token's vector its word's plus 0.2 of its neighbours'
    (tests/test_contextual.py's ctx_fn), zeros for any other token; it
    stands for a PCA-compressed transformer embedding."""
    import numpy as np

    import vectorian_tpu_torch as vt

    table = np.concatenate([rng.normal(size=(len(words), CTX_DIM)).astype(np.float32),
                            np.zeros((1, CTX_DIM), np.float32)])
    index_of = {w: i for i, w in enumerate(words)}

    def fn(tokens, text):
        base = table[[index_of.get(text[a:b], len(words)) for a, b in tokens]]
        out = base.copy()
        out[1:] += np.float32(0.2) * base[:-1]
        out[:-1] += np.float32(0.2) * base[1:]
        return out

    return vt.LambdaContextualEmbedding("ctx", fn, CTX_DIM)


def _dense_kernel_check(index, kernel, db, S, lts):
    """The dense entry ``kernel`` on a path's first chunk ``S`` [c, L,
    Tpad, Q] of bucket ``db`` (needle lengths ``lts``): the plan's route
    and every other route of ``DENSE_ROUTES`` the plan takes there, forced,
    held against the plain version bit for bit; timed on the device in
    turns against the old design (``old_dense``: old, new, ..., new, old)
    and on the host: (max |diff|, ms, plain ms, bound ms, bound by,
    (c, L, Tpad, Q), {"route", "old_ms", "route_ms", "host_ms",
    "launch_floor_ms"})."""
    import torch

    from vectorian_tpu_torch.ops import dp_kernels, search

    eng = index._engine
    c, L, Tpad, Q = S.shape
    ln = db["lengths"][:c]
    lt = torch.as_tensor(lts, dtype=torch.int32, device=eng.device)
    if kernel == "affine_dp[dense]":
        args, kw = (index._gaps,), {}
        fn, ref = dp_kernels.affine_dp_scores_dense, dp_kernels.affine_dp_scores_dense_reference
        registers = True
    else:
        gg = search.GeneralGaps(index._gap_costs, Tpad + 1, eng.device)
        args, kw = gg.vecs(L), {"host_costs": gg.host_vecs(L)}
        fn, ref = dp_kernels.wsb_dp_scores_dense, dp_kernels.wsb_dp_scores_dense_reference
        registers = dp_kernels._register_costs(L, Tpad, S, args, kw["host_costs"]) is not None
    route, others = dense_routes(kernel, S, registers)
    want = ref(S, ln, lt, *args, index._locality)

    def run(f):
        return lambda: fn(S, ln, lt, *args, index._locality, _route=f, **kw)

    d = _check_equal(kernel, run(None)(), want, (c, Tpad, Q, route))
    runs = {"old": old_dense(run("registers"), ln), route: run(None)}
    for f in others:
        d = max(d, _check_equal(kernel, run(f)(), want, (c, Tpad, Q, f)))
        runs[f] = run(f)
    means, times = device_turns(runs, 50)
    h_ms = host_ms(run(None), 10)
    plain_ms = cuda_ms(lambda: ref(S, ln, lt, *args, index._locality), 1)
    bound, by = dense_bound_ms(kernel, S, ln, lt)
    # a launch of almost no work on the same stream (the old clamp alone):
    # the device time any launch takes
    extra = {"route": route, "old_ms": means["old"], "route_ms": means,
             "host_ms": h_ms, "launch_floor_ms": device_ms(lambda: torch.clamp_min(ln, 1), 50)}
    emit({"phase": "kernel_dense_at_path", "name": kernel, "c_L_Tpad_Q": [c, L, Tpad, Q],
          "ms": means[route], **extra, "turns": times, "plain_ms": plain_ms,
          "bound_ms": bound})
    return (d, means[route], plain_ms, bound, by, [c, L, Tpad, Q], extra)


def _ctx_kernel_at_path(index, qs, kernel):
    """The dense entry at the contextual pass's shapes: the first chunk of
    the largest bucket as find_batch (Q = len(qs)) and find (Q = 1) build
    it, held against the plain version and timed: {Q: (max |diff|, ms,
    plain ms, bound ms, bound by, (c, L, Tpad, Q))}."""
    from vectorian_tpu_torch.ops import search
    from vectorian_tpu_torch.ops.simmatrix import ctx_similarity

    eng = index._engine
    db = max(eng._device_buckets, key=lambda b: b["n"])
    pqs = [index.make_query(q).prepare(index._nlp) for q in qs]
    plans = [index._compile_plan(pq, {"ctx"}) for pq in pqs]
    metric = index._args["metric"]["token_sim"].metric
    out = {}
    for Q in (len(qs), 1):
        lts = [max(pq.n_tokens, 1) for pq in pqs[:Q]]
        qv, Tpad = search.stack_ctx_queries([p.ctx_queries[0] for p in plans[:Q]], lts,
                                            eng.device)
        c = min(search.ctx_chunk(db["capacity"], Tpad, Q, CTX_DIM), db["n"])
        S = ctx_similarity(eng._ctx_dev("ctx", db["bi"])[:c], qv, metric).reshape(
            c, db["capacity"], Tpad, Q)
        out[Q] = _dense_kernel_check(index, kernel, db, S, lts)
    return out


def _tree_kernel_at_path(index, qs, kernel):
    """The dense entry at the tree pass's shapes (4h): the first chunk of
    the largest bucket as the stacked plans of find_batch (Q = len(qs))
    and of find (Q = 1) evaluate it (``stack_tree_plans`` +
    ``eval_plan_chunk``), held against the plain version and timed, as
    ``_ctx_kernel_at_path``."""
    from vectorian_tpu_torch.ops import search
    from vectorian_tpu_torch.ops.simmatrix import eval_plan_chunk

    eng = index._engine
    db = max(eng._device_buckets, key=lambda b: b["n"])
    pqs = [index.make_query(q).prepare(index._nlp) for q in qs]
    plans = [index._compile_plan(pq, {"ctx"}) for pq in pqs]
    out = {}
    for Q in (len(qs), 1):
        lts = [max(pq.n_tokens, 1) for pq in pqs[:Q]]
        sp, Tpad = search.stack_tree_plans(plans[:Q], lts, eng.device)
        d = sum(int(v.unmodified.shape[1]) for v in sp.ctx_vectors)
        c = min(search.ctx_chunk(db["capacity"], Tpad, Q, d), db["n"])
        S = eval_plan_chunk(sp, db["tokens"][:c], (eng._ctx_dev("ctx", db["bi"])[:c],))
        S = S["similarity"].reshape(c, db["capacity"], Tpad, Q).contiguous()
        out[Q] = _dense_kernel_check(index, kernel, db, S, lts)
    return out


def ctx_corpus(qft=None):
    """4f's corpus: (texts, the contextual embedding, the session over
    CTX_SENTENCES of phase 4's generator (with ``qft`` as a second
    embedding when given), 32 batch queries, 21 finds, the build s)."""
    import numpy as np

    import vectorian_tpu_torch as vt

    rng = np.random.default_rng(SEED + 10)
    words, texts, query = zipf_corpus(CTX_SENTENCES, rng)
    emb = _ctx_embedding(words, np.random.default_rng(SEED + 11))
    t0 = time.perf_counter()
    session = vt.Session([vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)],
                         embeddings=[emb, *([qft] if qft is not None else [])], device=DEVICE)
    build_s = time.perf_counter() - t0
    queries = [query() for _ in range(32)]
    finds = [query() for _ in range(21)]
    return texts, emb, session, queries, finds, build_s


def phase_contextual(card, qft=None):
    """4f: the contextual path end to end on the card: CTX_SENTENCES of
    phase 4's generator, a CTX_DIM LambdaContextualEmbedding; the store's
    packing (ensure_contextual), find p50 (21 queries) and find_batch Q=32
    (median of 3) under affine gaps and LocalAlignment(ExponentialGapCost(
    3.0)), find = find_batch byte for byte, the dense kernels at the path's
    shapes against their plain versions, a torch.profiler trace of one
    find_batch (the metric GEMM's time beside the dense DP's); then the
    card against the CPU on a 3,000-sentence cut of the corpus.  The
    session (and the cut's) also hold 4h's compressed fastText ``qft``,
    when given, as a second embedding, so phase 4h shares the session and
    its contextual store.  Returns (the dense kernels' results, {session, cut sessions by
    device, queries, finds} for 4h)."""
    import numpy as np

    import vectorian_tpu_torch as vt
    from vectorian_tpu_torch.alignment import ExponentialGapCost
    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.utils import trace

    texts, emb, session, queries, finds, build_s = ctx_corpus(qft)
    res, kernels = {}, {}
    for label, gap, kernel in (("affine", None, "affine_dp[dense]"),
                               ("general", ExponentialGapCost(3.0), "wsb_dp[dense]")):
        index = make_index(session, gap)
        t = time.perf_counter()
        index._engine.ensure_contextual("ctx", session.documents, session._ctx_dims["ctx"])
        ensure_s = time.perf_counter() - t
        index.find(finds[0], n=10, min_score=0.2)  # warm
        dp_kernels.reset_launches()
        ts, found = [], []
        for q in finds:
            t = time.perf_counter()
            found.append(pairs(index.find(q, n=10, min_score=0.2)))
            ts.append((time.perf_counter() - t) * 1e3)
        find_launches = dp_kernels.LAUNCHES[kernel]
        dp_kernels.reset_launches()
        walls, batch = [], None
        for _ in range(3):
            t = time.perf_counter()
            batch = index.find_batch(queries, n=10, min_score=0.2)
            walls.append((time.perf_counter() - t) * 1e3)
        launches = dp_kernels.LAUNCHES[kernel]
        if not launches or not find_launches:
            raise AssertionError(f"4f {label}: {kernel} was not launched")
        check_results(batch, 10, 0.2)
        if not any(found) or [pairs(r) for r in index.find_batch(finds, n=10, min_score=0.2)] != found:
            raise AssertionError(f"4f {label}: contextual find and find_batch differ")
        rows = profile_calls(f"contextual find_batch {label}",
                             lambda: index.find_batch(queries, n=10, min_score=0.2))
        trace.start()
        index.find_batch(queries, n=10, min_score=0.2)
        spans = {}
        for name, sec in trace.stop():
            spans[name] = spans.get(name, 0.0) + sec * 1e3
        emit({"phase": "contextual_split", "gap": label,
              "gemm_ms": sum(ms for k, ms, _ in rows if "gemm" in k.lower()),
              "dense_dp_ms": sum(ms for k, ms, _ in rows if "dense" in k),
              "host_spans_ms": spans})
        kernels[kernel] = _ctx_kernel_at_path(index, queries, kernel)
        kernels[kernel]["launches"] = launches
        n_slices = index.packed.n_slices
        res[label] = {"ensure_contextual_s": ensure_s, "find_p50_ms": float(np.median(ts)),
                      "find_launches": find_launches,
                      "find_batch_ms_median": float(np.median(walls)), "find_batch_ms": walls,
                      "alignments_per_s": n_slices * len(queries) / (np.median(walls) / 1e3),
                      "launches": launches}
    emit({"phase": "contextual", "sentences": CTX_SENTENCES, "slices": n_slices,
          "dim": CTX_DIM, "session_build_s": build_s, **res, "card": card})
    del index

    # the card against the CPU on a 3,000-sentence cut of the corpus
    on = {dev: vt.Session([vt.StringImporter()(t, title=f"d{i}")
                           for i, t in enumerate(corpus_cut(texts))],
                          embeddings=[emb, *([qft] if qft is not None else [])], device=dev)
          for dev in (DEVICE, "cpu")}
    worst = {}
    for label, gap in (("affine", None), ("general", ExponentialGapCost(3.0))):
        got = {}
        for dev, sess in on.items():
            ix = make_index(sess, gap)
            got[dev] = ([pairs(ix.find(q, n=10, min_score=0.1)) for q in finds[:4]]
                        + [pairs(r) for r in ix.find_batch(queries[:8], n=10, min_score=0.1)])
        if not any(got[DEVICE]):
            raise AssertionError(f"4f {label}: no matches on the cut")
        worst[label] = compare_with_cpu(f"4f cut {label}", got[DEVICE], got["cpu"])
    emit({"phase": "contextual_vs_cpu", "sentences": 3_000,
          "max_abs_score_diff_vs_cpu": worst})
    return kernels, {"session": session, "cut": on, "queries": queries, "finds": finds}


def corpus_cut(texts, n_sents=3_000):
    """The first ``n_sents`` sentences of a phase-4 corpus (9 words a
    sentence) as documents of 2,000 sentences, as the corpus's."""
    items = " ".join(texts).split(" ")[: 9 * n_sents]
    return [" ".join(items[i : i + 9 * 2_000]) for i in range(0, len(items), 9 * 2_000)]


# 4h's product quantization of 4d's fastText matrix: 15 subvectors of 20
# dims, 256 codes each, k-means on a training sample of FT_PQ_TRAIN rows
FT_PQ_TRAIN, FT_PQ_ITERS = 16_384, 6


def compress_fasttext(ft):
    """4h's static leaf: phase 4d's fastText model (2,000,000 buckets, 300d)
    product-quantized by the port's QuantizedFastTextModel.compress on a
    training sample (every row encoded), saved as .npz into a temporary
    directory and loaded as QuantizedFastText "qft"; returns (the
    embedding, {"compress_s", "npz_bytes", "load_s"})."""
    from vectorian_tpu_torch.embedding.fasttext import (
        QuantizedFastText,
        QuantizedFastTextModel,
    )

    t = time.perf_counter()
    q = QuantizedFastTextModel.compress(ft.model, n_train=FT_PQ_TRAIN, n_iters=FT_PQ_ITERS)
    compress_s = time.perf_counter() - t
    with tempfile.TemporaryDirectory(prefix="chip_smoke_qft_") as tmp:
        path = Path(tmp) / "cc.en.300.quant.npz"
        q.save(path)
        qft = QuantizedFastText(path, name="qft")
        t = time.perf_counter()
        qft.model  # noqa: B018  (loads the .npz before the directory goes)
        load_s = time.perf_counter() - t
        nbytes = path.stat().st_size
    return qft, {"compress_s": compress_s, "npz_bytes": nbytes, "load_s": load_s,
                 "pq_train_rows": FT_PQ_TRAIN, "pq_iters": FT_PQ_ITERS}


def _device_split(rows):
    """A profile's device ms by kind: the static leaves' gathers, the metric
    GEMM, the dense DP kernels and the rest."""
    split = {"gather_ms": 0.0, "gemm_ms": 0.0, "dense_dp_ms": 0.0, "other_ms": 0.0}
    for name, ms, _ in rows:
        k = name.lower()
        if "dense" in k:
            split["dense_dp_ms"] += ms
        elif "gemm" in k or "xmma" in k or "cutlass" in k:
            split["gemm_ms"] += ms
        elif "index" in k or "gather" in k:
            split["gather_ms"] += ms
        else:
            split["other_ms"] += ms
    busy = sum(split.values())
    split["gemm_share"] = split["gemm_ms"] / busy if busy else 0.0
    return split


def phase_config4(ctx, qft, qft_info, card):
    """4h: BASELINE config 4 at full width on 4f's session and contextual
    store (CTX_SENTENCES sentences): MixedTokenSimilarity of the compressed
    fastText 300d (``qft``) and the d = 256 contextual embedding, weights
    0.5 / 0.5, under affine gaps and ExponentialGapCost(3.0).  Per gap
    model: find_batch Q=32 (median of 3) and find p50 of 21, the launch
    counts set to 0 right before and read right after (each dense entry
    must have run), find = find_batch byte for byte, a torch.profiler split
    of one find_batch's device time (leaf gather, GEMM, dense DP), each
    dense entry held against its plain version on the tree pass's first
    chunk (Q = 32 and 1); then one tagged contextual find_batch (the tree
    pass with one leaf); then the card against the CPU on 4f's
    3,000-sentence cut.  Returns the dense kernels' results at the tree
    pass."""
    import numpy as np

    from vectorian_tpu_torch.alignment import ExponentialGapCost, LocalAlignment
    from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim
    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.sim.modifier import MixedTokenSimilarity

    session, queries, finds = ctx["session"], ctx["queries"], ctx["finds"]

    def tree_index(sess, gap):
        c, q = sess.embeddings
        mixed = MixedTokenSimilarity([EmbeddingTokenSim(q), EmbeddingTokenSim(c)], [0.5, 0.5])
        return sess.partition("sentence").index(OptimizedSpanSim(
            mixed, LocalAlignment() if gap is None else LocalAlignment(gap)))

    res, kernels = {}, {}
    for label, gap, kernel in (("affine", None, "affine_dp[dense]"),
                               ("general", ExponentialGapCost(3.0), "wsb_dp[dense]")):
        index = tree_index(session, gap)
        index.find_batch(queries[:2], n=10, min_score=0.2)  # warm
        # ---- the main path: launch counts from 0, read right after ----
        dp_kernels.reset_launches()
        walls, batch = [], None
        for _ in range(3):
            t = time.perf_counter()
            batch = index.find_batch(queries, n=10, min_score=0.2)
            walls.append((time.perf_counter() - t) * 1e3)
        ts, found = [], []
        for q in finds:
            t = time.perf_counter()
            found.append(pairs(index.find(q, n=10, min_score=0.2)))
            ts.append((time.perf_counter() - t) * 1e3)
        launches = dp_kernels.LAUNCHES[kernel]
        # ---- end of the main path ----
        if not launches:
            raise AssertionError(f"4h {label}: {kernel} was not launched")
        check_results(batch, 10, 0.2)
        if not any(found) or [pairs(r) for r in index.find_batch(finds, n=10, min_score=0.2)] != found:
            raise AssertionError(f"4h {label}: mixed-tree find and find_batch differ")
        rows = profile_calls(f"config4 find_batch {label}",
                             lambda: index.find_batch(queries, n=10, min_score=0.2))
        split = _device_split(rows)
        emit({"phase": "config4_split", "gap": label, **split})
        kernels[kernel] = _tree_kernel_at_path(index, queries, kernel)
        kernels[kernel]["launches"] = launches
        n_slices = index.packed.n_slices
        res[label] = {"find_batch_ms_median": float(np.median(walls)), "find_batch_ms": walls,
                      "alignments_per_s": n_slices * len(queries) / (np.median(walls) / 1e3),
                      "find_p50_ms": float(np.median(ts)), "launches": launches,
                      "gemm_share": split["gemm_share"]}
    # a contextual metric with tag weights: its batch takes the tree pass
    index = make_index(session, None, **TAG_ARGS)
    index.find_batch(queries[:2], n=10, min_score=0.2)  # warm
    dp_kernels.reset_launches()
    t = time.perf_counter()
    tagged = index.find_batch(queries, n=10, min_score=0.2)
    tagged_ms = (time.perf_counter() - t) * 1e3
    tagged_launches = dp_kernels.LAUNCHES["affine_dp[dense]"]
    check_results(tagged, 10, 0.2)
    if not tagged_launches or [pairs(r) for r in tagged[:4]] != [
            pairs(index.find(q, n=10, min_score=0.2)) for q in queries[:4]]:
        raise AssertionError("4h: the tagged contextual find_batch is not find's")
    emit({"phase": "config4", "sentences": CTX_SENTENCES, "slices": n_slices,
          "static": {"bucket": FT_BUCKET, "dim": FT_DIM, **qft_info}, "ctx_dim": CTX_DIM,
          "weights": [0.5, 0.5], **res, "tagged_ctx_find_batch_ms": tagged_ms,
          "tagged_ctx_launches": tagged_launches, "card": card})

    worst = {}
    for label, gap in (("affine", None), ("general", ExponentialGapCost(3.0))):
        got = {}
        for dev, sess in ctx["cut"].items():
            ix = tree_index(sess, gap)
            got[dev] = ([pairs(ix.find(q, n=10, min_score=0.1)) for q in finds[:4]]
                        + [pairs(r) for r in ix.find_batch(queries[:8], n=10, min_score=0.1)])
        if not any(got[DEVICE]):
            raise AssertionError(f"4h {label}: no matches on the cut")
        worst[label] = compare_with_cpu(f"4h cut {label}", got[DEVICE], got["cpu"])
    emit({"phase": "config4_vs_cpu", "sentences": 3_000, "max_abs_score_diff_vs_cpu": worst})
    return kernels


def _transport_metrics():
    from vectorian_tpu_torch.alignment import WordMoversDistance, WordRotatorsDistance

    return (("rwmd", WordMoversDistance()), ("wmd", WordMoversDistance(relaxed=False)),
            ("wrd", WordRotatorsDistance()))


def _transport_index(session, metric):
    from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim

    return session.partition("sentence").index(
        OptimizedSpanSim(EmbeddingTokenSim(session.embeddings[0]), metric))


def phase_transport(session, finds, cut, card):
    """4i: the transport metrics' find on phase 4's 1M-slice session:
    WordMoversDistance() (relaxed, the default), WordMoversDistance(
    relaxed=False) and WordRotatorsDistance(), find p50 of 21 each, with
    the trace spans of the device ranking pass (``wmd.rank``: its enqueue)
    and the host rescore (``wmd.host_rescore``: the fetch, the host
    arithmetic and the exact solves), the candidates rescored a find (the
    relaxed pool, or the exact EMD solves), and the ranking pass alone
    timed on the card (CUDA events).  Then on the 3,000-sentence cut
    (``cut``: sessions by device) the card against the CPU, and full WMD
    and WRD against the exhaustive exact-EMD oracle (find(q, n=n_slices +
    8, min_score=-1.0) solves every slice)."""
    import numpy as np

    from vectorian_tpu_torch.ops import wmd
    from vectorian_tpu_torch.utils import trace

    solved = {"n": 0}
    orig = {name: getattr(wmd.WMDEngine, name)
            for name in ("_host_rescore", "_relaxed_finalize")}

    def counted(name):
        def fn(self, index, query, qp, state, top, *a, **kw):
            solved["n"] += len(top)
            return orig[name](self, index, query, qp, state, top, *a, **kw)
        return fn

    out = {}
    try:
        for name in orig:
            setattr(wmd.WMDEngine, name, counted(name))
        for label, metric in _transport_metrics():
            index = _transport_index(session, metric)
            index.find(finds[0], n=10, min_score=0.2)  # warm
            ts, rank_ms, host_ms, per_find, found = [], [], [], [], []
            for q in finds:
                solved["n"] = 0
                trace.start()
                t = time.perf_counter()
                found.append(index.find(q, n=10, min_score=0.2))
                ts.append((time.perf_counter() - t) * 1e3)
                spans = trace.stop()
                rank_ms.append(sum(s for k, s in spans if k == "wmd.rank") * 1e3)
                host_ms.append(sum(s for k, s in spans if k == "wmd.host_rescore") * 1e3)
                per_find.append(solved["n"])
            check_results(found, 10, 0.2)
            if not any(len(r) for r in found):
                raise AssertionError(f"4i {label}: no matches")
            pq = index.make_query(finds[1]).prepare(index._nlp)
            qp = index._compile_plan(pq, (), needs_magnitudes=label == "wrd")
            eng = wmd.WMDEngine(index._engine, index._args["alignment"])
            rank_device_ms = cuda_ms(lambda: eng._score(index, pq, qp, device=True), 3)
            out[label] = {"find_p50_ms": float(np.median(ts)),
                          "rank_span_ms_p50": float(np.median(rank_ms)),
                          "host_rescore_span_ms_p50": float(np.median(host_ms)),
                          "rank_pass_device_ms": rank_device_ms,
                          "rescored_per_find_median": float(np.median(per_find)),
                          "rescored_per_find_max": int(max(per_find))}
        emit({"phase": "transport", "slices": session.packed_corpus(
            session.partition("sentence").spec).n_slices, "finds": len(finds), **out,
            "card": card})

        worst, oracle = {}, {}
        for label, metric in _transport_metrics():
            got = {dev: [pairs(_transport_index(sess, metric).find(q, n=10, min_score=0.2))
                         for q in finds[:4]] for dev, sess in cut.items()}
            if not any(got[DEVICE]):
                raise AssertionError(f"4i {label}: no matches on the cut")
            worst[label] = compare_with_cpu(f"4i cut {label}", got[DEVICE], got["cpu"])
            if label == "rwmd":
                continue
            ix = _transport_index(cut[DEVICE], metric)
            n_slices = ix.packed.n_slices
            for q, g in zip(finds[:2], got[DEVICE]):
                solved["n"] = 0
                exhaustive = pairs(ix.find(q, n=n_slices + 8, min_score=-1.0))
                if solved["n"] < n_slices:
                    raise AssertionError(f"4i {label}: the oracle solved {solved['n']} slices")
                want = [p for p in exhaustive if p[1] > 0.2][:10]
                if g != want:
                    raise AssertionError(f"4i {label}: find {g} != the exhaustive oracle {want}")
            oracle[label] = "equal"
        emit({"phase": "transport_vs_cpu", "sentences": 3_000,
              "max_abs_score_diff_vs_cpu": worst, "exhaustive_oracle": oracle})
    finally:
        for name, fn in orig.items():
            setattr(wmd.WMDEngine, name, fn)
    return out


def phase_span(session, queries, finds, cut, card):
    """4j: span embeddings on phase 4's 1M slices: SentenceEmbedding of the
    300d KeyedVectors ("mean") through EmbeddedSpanSim's exact index (the
    corpus encode on the card, find p50 of 21, find_batch Q=32 median of 3)
    and with approximate={"nlist": 64, "nprobe": 8} (the JAX package's
    default: the k-means training, find p50, find_batch, recall@10 of the
    32 queries against the exact index); then the exact index on the card
    against the CPU on the 3,000-sentence cut."""
    import numpy as np
    import torch

    import vectorian_tpu_torch as vt
    from vectorian_tpu_torch.sim.span import EmbeddedSpanSim

    def span_index(sess, **kw):
        return sess.partition("sentence").index(
            EmbeddedSpanSim(vt.SentenceEmbedding(sess.embeddings[0], "mean")), **kw)

    def drive(index):
        index.find(finds[0], n=10, min_score=0.2)  # warm
        ts = []
        for q in finds:
            t = time.perf_counter()
            index.find(q, n=10, min_score=0.2)
            ts.append((time.perf_counter() - t) * 1e3)
        walls, batch = [], None
        for _ in range(3):
            t = time.perf_counter()
            batch = index.find_batch(queries, n=10, min_score=-1.0)
            walls.append((time.perf_counter() - t) * 1e3)
        check_results(batch, 10, -1.0)
        return batch, {"find_p50_ms": float(np.median(ts)),
                       "find_batch_ms_median": float(np.median(walls)), "find_batch_ms": walls}

    exact = span_index(session)
    torch.cuda.synchronize()
    t = time.perf_counter()
    vecs = exact._corpus_vectors()
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t
    if not bool(torch.isfinite(vecs.unmodified).all()):
        raise AssertionError("4j: non-finite span vectors")
    want, res_exact = drive(exact)
    approx = span_index(session, approximate={"nlist": 64, "nprobe": 8})
    approx._corpus_vecs = vecs  # the same encoder output: no second encode
    t = time.perf_counter()
    approx._train()
    kmeans_s = time.perf_counter() - t
    got, res_approx = drive(approx)
    recall = [len({s for s, _ in pairs(g)} & {s for s, _ in pairs(w)}) / max(len(w), 1)
              for g, w in zip(got, want)]
    emit({"phase": "span", "slices": vecs.size, "dim": int(vecs.unmodified.shape[1]),
          "encode_s": encode_s, "exact": res_exact,
          "approximate": {"nlist": 64, "nprobe": 8, "kmeans_s": kmeans_s,
                          "recall_at_10_mean": float(np.mean(recall)),
                          "recall_at_10_min": float(np.min(recall)), **res_approx},
          "card": card})
    got_cut = {dev: [pairs(span_index(sess).find(q, n=10, min_score=0.2)) for q in finds[:4]]
               for dev, sess in cut.items()}
    if not any(got_cut[DEVICE]):
        raise AssertionError("4j: no matches on the cut")
    emit({"phase": "span_vs_cpu", "sentences": 3_000, "max_abs_score_diff_vs_cpu":
          compare_with_cpu("4j cut", got_cut[DEVICE], got_cut["cpu"])})
    return {"encode_s": encode_s, "kmeans_s": kmeans_s, **res_exact}


class _TransportCounts:
    """Counters of a transport batch, installed on WMDEngine for a block:
    the exact solves (``_host_rescore``'s candidates) and relaxed rescores
    (``_relaxed_finalize``'s pools), the consume rounds (one a call of the
    host-rescore loop's window), the (slice, query) pairs the fused
    similarity fetch gathered, and the ranking passes' device ms (CUDA
    events around each ``_buckets_pass``)."""

    def __init__(self):
        from vectorian_tpu_torch.ops import wmd

        self.wmd = wmd
        self.names = ("_host_rescore", "_relaxed_finalize", "_sims_many_static_dispatch",
                      "_sims_many_plan", "_buckets_pass")
        self.orig = {n: getattr(wmd.WMDEngine, n) for n in self.names}
        self.reset()

    def reset(self):
        self.solves = self.relaxed = self.rounds = self.pairs = 0
        self.events = []

    def __enter__(self):
        import torch

        orig, cnt = self.orig, self

        def host_rescore(eng, index, query, qp, state, top, *a, **kw):
            cnt.solves += len(top)
            cnt.rounds += 1
            return orig["_host_rescore"](eng, index, query, qp, state, top, *a, **kw)

        def relaxed(eng, index, query, qp, state, top, *a, **kw):
            cnt.relaxed += len(top)
            return orig["_relaxed_finalize"](eng, index, query, qp, state, top, *a, **kw)

        def pairs_static(eng, items, *a, **kw):
            cnt.pairs += sum(len(s) for _, s in items)
            return orig["_sims_many_static_dispatch"](eng, items, *a, **kw)

        def pairs_plan(eng, items, *a, **kw):
            cnt.pairs += sum(len(s) for _, s in items)
            return orig["_sims_many_plan"](eng, items, *a, **kw)

        def buckets_pass(eng, fn):
            if eng._engine.device.type != "cuda":
                return orig["_buckets_pass"](eng, fn)
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            out = orig["_buckets_pass"](eng, fn)
            end.record()
            cnt.events.append((start, end))
            return out

        for name, fn in zip(self.names, (host_rescore, relaxed, pairs_static, pairs_plan,
                                         buckets_pass)):
            setattr(self.wmd.WMDEngine, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.wmd.WMDEngine, name, fn)

    def rank_ms(self):
        """The ranking passes' device ms since the last reset (each pass
        queues every bucket before the top-k reads them; paged passes
        include their uploads)."""
        import torch

        if not self.events:
            return None
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def _drive_transport_batch(index, queries, counts, reps=3):
    """Median-of-``reps`` wall ms of ``index.find_batch(queries)`` and, per
    batch, the ranking passes' device ms, the trace spans (ms), exact
    solves, relaxed rescores, consume rounds and fetched pairs: (median,
    walls, per batch), the last batch.  Then one untimed loop of
    ``index.find`` over the same queries, its bytes held equal to the last
    batch's."""
    import numpy as np

    from vectorian_tpu_torch.utils import trace

    walls, per, batch = [], [], None
    for _ in range(reps):
        counts.reset()
        trace.start()
        t = time.perf_counter()
        batch = index.find_batch(queries, n=10, min_score=0.2)
        walls.append((time.perf_counter() - t) * 1e3)
        spans = {}
        for k, sec in trace.stop():
            if k.startswith("wmd."):
                spans[k] = spans.get(k, 0.0) + sec * 1e3
        per.append({"rank_pass_device_ms": counts.rank_ms(), "spans_ms": spans,
                    "exact_solves": counts.solves, "relaxed_rescored": counts.relaxed,
                    "consume_rounds": counts.rounds, "fetched_pairs": counts.pairs})
    check_results(batch, 10, 0.2)
    if not any(len(r) for r in batch):
        raise AssertionError("transport find_batch: no matches")
    if [pairs(index.find(q, n=10, min_score=0.2)) for q in queries] != [
            pairs(r) for r in batch]:
        raise AssertionError("transport find_batch: not the bytes of a loop of find")
    return (float(np.median(walls)), walls, per), batch


def phase_transport_batch(session, queries, cut, card):
    """4k: the transport find_batch on phase 4's 1M-slice session:
    WordMoversDistance() (relaxed), WordMoversDistance(relaxed=False) and
    WordRotatorsDistance(), each on the Q=32 queries of 7 tokens: wall ms
    (``TRANSPORT_REPS`` batches), the seconds of those batches' loop
    (warm calls and the loop of find included), alignments/s
    (slices x Q / s), the ranking pass's CUDA-
    event ms, the host spans (``wmd.rank``: pass and top-k reads;
    ``wmd.sims_fetch``; ``wmd.host_rescore``), the consume rounds and exact
    solves a batch and the pairs the fused fetch gathered; a loop of find
    over the 32 queries, untimed, is the last batch's bytes.  Then on the
    3,000-sentence cut: the card against the CPU, each query's find bytes
    equal to the batch's, full WMD and WRD equal to the exhaustive oracle.
    Returns {metric: the last batch's (slice_id, score) lists} (4m's
    twins)."""
    n_slices = session.packed_corpus(session.partition("sentence").spec).n_slices
    out, batches = {}, {}
    with _TransportCounts() as counts:
        t0 = time.perf_counter()
        for label, metric in _transport_metrics():
            index = _transport_index(session, metric)
            index.find_batch(queries[:2], n=10, min_score=0.2)  # warm
            (med, walls, per), batch = _drive_transport_batch(index, queries, counts,
                                                              reps=TRANSPORT_REPS)
            out[label] = {"find_batch_ms_median": med, "find_batch_ms": walls,
                          "alignments_per_s": n_slices * len(queries) / (med / 1e3),
                          "per_batch": per}
            batches[label] = [pairs(r) for r in batch]
        emit({"phase": "transport_batch", "slices": n_slices, "queries": len(queries),
              "reps": TRANSPORT_REPS, "batches_s": time.perf_counter() - t0,
              **out, "card": card})
        worst, oracle = {}, {}
        for label, metric in _transport_metrics():
            got = {}
            for dev, sess in cut.items():
                ix = _transport_index(sess, metric)
                got[dev] = [pairs(r) for r in ix.find_batch(queries[:8], n=10, min_score=0.2)]
                if dev == DEVICE:
                    finds = [pairs(ix.find(q, n=10, min_score=0.2)) for q in queries[:8]]
                    if got[dev] != finds:
                        raise AssertionError(f"4k {label}: find_batch is not find's bytes")
            if not any(got[DEVICE]):
                raise AssertionError(f"4k {label}: no matches on the cut")
            worst[label] = compare_with_cpu(f"4k cut {label}", got[DEVICE], got["cpu"])
            if label == "rwmd":
                continue
            ix = _transport_index(cut[DEVICE], metric)
            n_cut = ix.packed.n_slices
            for q, g in zip(queries[:3], got[DEVICE]):
                exhaustive = pairs(ix.find(q, n=n_cut + 8, min_score=-1.0))
                if g != [p for p in exhaustive if p[1] > 0.2][:10]:
                    raise AssertionError(f"4k {label}: the batch is not the exhaustive oracle")
            oracle[label] = "equal"
    emit({"phase": "transport_batch_vs_cpu", "sentences": 3_000,
          "max_abs_score_diff_vs_cpu": worst, "exhaustive_oracle": oracle})
    return batches


def phase_transport_tree(ctx, card):
    """4k on 4h's mixed tree (CTX_SENTENCES sentences, 4f's session and store):
    relaxed-WMD find_batch Q=32 of MixedTokenSimilarity([qft, ctx], [0.5,
    0.5]) (median of 3), its bytes equal to a loop of find's over the 32
    queries."""
    from vectorian_tpu_torch.alignment import WordMoversDistance
    from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim
    from vectorian_tpu_torch.sim.modifier import MixedTokenSimilarity

    session, queries = ctx["session"], ctx["queries"]
    c, q = session.embeddings
    index = session.partition("sentence").index(OptimizedSpanSim(MixedTokenSimilarity(
        [EmbeddingTokenSim(q), EmbeddingTokenSim(c)], [0.5, 0.5]), WordMoversDistance()))
    with _TransportCounts() as counts:
        index.find_batch(queries[:2], n=10, min_score=0.2)  # warm
        (med, walls, per), _ = _drive_transport_batch(index, queries, counts)
    n_slices = index.packed.n_slices
    res = {"find_batch_ms_median": med, "find_batch_ms": walls,
           "alignments_per_s": n_slices * len(queries) / (med / 1e3), "per_batch": per}
    emit({"phase": "transport_batch_tree", "slices": n_slices, "rwmd": res, "card": card})
    return res


# 4m: a mesh of four shards on the run's one card (a port mesh is a list of
# torch devices, and a device may repeat: the code path that serves four
# cards)
MESH_DEVICES = ["cuda:0"] * 4


def _mesh_ms():
    import vectorian_tpu_torch as vt

    return vt.MeshSearch(vt.make_mesh(MESH_DEVICES))


def _mesh_twins(label, mesh, single, want=None, turns=1):
    """A mesh call against its single-device twin: ``mesh()`` with the
    launch counts set to 0 right before and read right after (the mesh
    path's launches and routes), its (slice_id, score) lists held equal to
    ``single()``'s (or to ``want``, an earlier phase's lists of the same
    call); then wall ms in turns (mesh, single, single, mesh) x
    ``turns``.  Emits and returns {launches, routes, the first call's wall,
    with ``turns`` mesh_ms, single_ms (medians), their runs and their
    ratio, the mesh call's host spans: mesh.dispatch (queueing every
    shard's pass), topk.fetch (waiting for the shards' top-k), topk.merge
    (the host merge), rescore_many, and its extras selects on the
    shards}."""
    import numpy as np

    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.utils import trace

    dp_kernels.reset_launches()
    trace.start()
    t = time.perf_counter()
    got = mesh()
    first_ms = (time.perf_counter() - t) * 1e3
    spans = trace.stop()
    launches = {k: v for k, v in dp_kernels.LAUNCHES.items() if v}
    routes = {**{f"affine:{k}": v for k, v in dp_kernels.AFFINE_ROUTE_LAUNCHES.items() if v},
              **{f"wsb:{k}": v for k, v in dp_kernels.WSB_ROUTE_LAUNCHES.items() if v}}
    got = [pairs(r) for r in got]
    if want is None:
        want = [pairs(r) for r in single()]
    if got != want:
        raise AssertionError(f"4m {label}: the mesh's lists differ from the single device's")
    if not any(got):
        raise AssertionError(f"4m {label}: no matches")
    walls = {"mesh": [], "single": []}
    for _ in range(turns):
        for which in ("mesh", "single", "single", "mesh"):
            t = time.perf_counter()
            (mesh if which == "mesh" else single)()
            walls[which].append((time.perf_counter() - t) * 1e3)

    def span(name):
        return sum(sec for n, sec in spans if n == name) * 1e3

    res = {"launches": launches, "routes": routes, "first_call_ms": first_ms,
           "dispatch_host_ms": span("mesh.dispatch"), "fetch_host_ms": span("topk.fetch"),
           "merge_host_ms": span("topk.merge"), "rescore_many_ms": span("rescore_many"),
           "extras_selects": sum(1 for n, _ in spans if n == "above.vals")}
    if turns:
        res.update(mesh_ms=float(np.median(walls["mesh"])),
                   single_ms=float(np.median(walls["single"])),
                   mesh_ms_all=walls["mesh"], single_ms_all=walls["single"])
        res["mesh_over_single"] = res["mesh_ms"] / res["single_ms"]
    emit({"phase": "mesh", "call": label, **res})
    return res


def _mesh_gather_check(index, ms, qs, kernel, dt, tagged=False):
    """Kernel 1 or 3 on one shard's inputs as the static mesh pass gives
    them (shard 0 of the largest bucket: its token ids, lengths and pos
    ids on its device, the batch's table at ``dt``), held against the
    plain version bit for bit; and at f32 untagged the four shards'
    launches, one after another, timed on the device against the
    unsharded bucket's one launch (CUDA events): (max |diff|, timing or
    None)."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.dp_kernels import TagBlock
    from vectorian_tpu_torch.ops.search import (
        corpus_tag_columns, scaled_costs, stack_query_tables, tag_arrays,
    )

    dev = torch.device(MESH_DEVICES[0])
    _, plans, len_ts, _, tagws, _ = index._prepare_static_batch(qs, 10, 0.2, "float32", {})
    table, scale, _, Tpad = stack_query_tables(plans, len_ts, dt)
    gaps, general, _ = scaled_costs(index._gaps, index._gap_costs, scale, Tpad, dev)
    lt = torch.as_tensor(np.asarray(len_ts, np.int32), device=dev)
    db, (tok, ln, pos, _) = max(ms.bucket_shards(index._engine), key=lambda e: e[0]["n"])
    L = db["capacity"]
    tags = None
    if tagged:
        cols = [torch.as_tensor(c, device=dev)
                for c in tag_arrays(corpus_tag_columns(tagws, len(qs), Tpad))]
        tags = lambda i: TagBlock(pos.parts[i], *cols)  # noqa: E731

    def call(t, n, i=None):
        tg = None if tags is None else tags(i)
        if kernel == "affine_dp":
            args = (table, t, n, lt, gaps, "local")
            return (dp_kernels.affine_dp_scores(*args, tags=tg),
                    lambda: dp_kernels.affine_dp_scores_reference(*args, tags=tg))
        args = (table, t, n, lt, *general.vecs(L), "local")
        return (dp_kernels.wsb_dp_scores(*args, host_costs=general.host_vecs(L), tags=tg),
                lambda: dp_kernels.wsb_dp_scores_reference(*args, tags=tg))

    got, plain = call(tok.parts[0], ln.parts[0], 0)
    err = _check_equal(f"{kernel} mesh shard", got, plain(),
                       [int(tok.parts[0].shape[0]), L, Tpad, len(qs), dt or "f32"])
    if dt is not None or tagged:
        return err, None

    def shards():
        for i in range(len(tok.parts)):
            call(tok.parts[i], ln.parts[i], i)

    def whole():
        call(db["tokens"], db["lengths"])

    turns = [cuda_ms(shards, 5), cuda_ms(whole, 5), cuda_ms(whole, 5), cuda_ms(shards, 5)]
    return err, {"shards_ms": (turns[0] + turns[3]) / 2, "unsharded_ms": (turns[1] + turns[2]) / 2,
                 "shards_whole_whole_shards_ms": turns, "bucket_rows": int(db["n"]),
                 "shard_rows": [int(p.shape[0]) for p in tok.parts]}


def phase_mesh_static(session, queries, finds, card):
    """4m, static: on phase 4's session (1M slices) find_batch Q=32 over a
    mesh of MESH_DEVICES at int8, bf16 and f32 under zero affine gaps and
    ExponentialGapCost(3.0), 4e's tag weights (f32) under both, and 21
    ``find(mesh=)`` calls, each byte-identical to the same call without a
    mesh and timed against it in turns (``_mesh_twins``); kernels 1 and 3
    on one shard's inputs (each table type, tagged) against their plain
    versions, and the shards' launches against the unsharded one.
    Returns {"launches": kernel -> the mesh path's launches, "err": kernel
    -> max |diff| on a shard, "shard_ms": kernel -> the timing}."""
    import vectorian_tpu_torch as vt
    from vectorian_tpu_torch.alignment import ExponentialGapCost

    try:
        n_cards = len(vt.make_mesh().devices)
    except RuntimeError:
        n_cards = 0
    ms = _mesh_ms()
    emit({"phase": "mesh_devices", "make_mesh_devices": n_cards,
          "mesh": [str(d) for d in ms.mesh.devices]})
    out = {"launches": {}, "err": {}, "shard_ms": {}}

    def add(launches):
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    kw = dict(n=10, min_score=0.2)
    for label, gap, kernel in (("affine", None, "affine_dp"),
                               ("general", ExponentialGapCost(3.0), "wsb_dp")):
        index = make_index(session, gap)
        for prec in PRECISIONS:
            p = {"sim_precision": prec}
            r = _mesh_twins(f"static {label} {prec or 'int8'}",
                            lambda: index.find_batch(queries, mesh=ms, **kw, **p),
                            lambda: index.find_batch(queries, **kw, **p))
            name = kernel + ("" if prec == "float32" else f"[{QUANT_TAGS[prec or 'int8']}]")
            if not r["launches"].get(name):
                raise AssertionError(f"4m {label} {prec}: the mesh launched no {name}")
            add(r["launches"])
            dt = None if prec == "float32" else (prec or "int8")
            err, timing = _mesh_gather_check(index, ms, queries, kernel, dt)
            out["err"][name] = err
            if timing is not None:
                out["shard_ms"][kernel] = timing
                emit({"phase": "mesh_shard_launches", "kernel": kernel, **timing,
                      "card": card})
        if gap is None:
            r = _mesh_twins("static affine find x21",
                            lambda: [index.find(q, mesh=ms, **kw) for q in finds],
                            lambda: [index.find(q, **kw) for q in finds])
            add(r["launches"])
        tagged = make_index(session, gap, **TAG_ARGS)
        r = _mesh_twins(f"static {label} tag weights",
                        lambda: tagged.find_batch(queries, mesh=ms, **kw),
                        lambda: tagged.find_batch(queries, **kw))
        if not r["launches"].get(kernel + "[tagged]"):
            raise AssertionError(f"4m {label} tag weights: the mesh launched no tagged kernel")
        add(r["launches"])
        out["err"][kernel + "[tagged]"], _ = _mesh_gather_check(
            tagged, ms, queries, kernel, None, tagged=True)
    return out


def phase_mesh_transport(session, queries, batches, turns=0):
    """4m, transport: 4k's find_batch (relaxed, full WMD, WRD; Q=32 on
    phase 4's 1M slices) over the mesh, once each, its lists = 4k's last
    batch's; with ``turns`` (``--mesh-check``), after that first (warm)
    call, its wall in turns against the same batch without a mesh (three
    metrics x 4 batches of 4-9 s: the full run leaves them out for its
    time)."""
    ms = _mesh_ms()
    for label, metric in _transport_metrics():
        index = _transport_index(session, metric)
        _mesh_twins(f"transport {label}",
                    lambda: index.find_batch(queries, n=10, min_score=0.2, mesh=ms),
                    lambda: index.find_batch(queries, n=10, min_score=0.2),
                    want=batches[label], turns=turns)


def _mesh_dense_check(index, ms, qs, kernel, tree):
    """The dense entry of kernel 1 or 3 on one shard's inputs as the
    contextual (or tree) mesh pass gives them: the first chunk of shard 0
    of the largest bucket (a row view of the engine's store), its block
    made by the pass's ``TreePass`` on the shard's device, held against
    the plain version bit for bit."""
    import torch

    from vectorian_tpu_torch.ops import dp_kernels, search

    dev = torch.device(MESH_DEVICES[0])
    pqs = [index.make_query(q).prepare(index._nlp) for q in qs]
    plans = [index._compile_plan(pq, {"ctx"}) for pq in pqs]
    lts = [max(pq.n_tokens, 1) for pq in pqs]
    tp = search.TreePass(plans, lts, index._gaps, index._locality,
                         [float(x) for x in lts], dev, index._gap_costs)
    db, (tok, ln, _, _) = max(ms.bucket_shards(index._engine), key=lambda e: e[0]["n"])
    ctx = ms.ctx_shards(index._engine, "ctx")[db["bi"]]
    c = min(search.ctx_chunk(db["capacity"], tp.Tpad, tp.Q, tp.d), int(tok.parts[0].shape[0]))
    view = {"tokens": tok.parts[0], "ctx": {"ctx": ctx.parts[0]}}
    S = tp.block(view, 0, c).contiguous()
    n = ln.parts[0][:c]
    if kernel == "affine_dp[dense]":
        args, kw = (index._gaps,), {}
        fn, ref = dp_kernels.affine_dp_scores_dense, dp_kernels.affine_dp_scores_dense_reference
    else:
        L = db["capacity"]
        args, kw = tp.general.vecs(L), {"host_costs": tp.general.host_vecs(L)}
        fn, ref = dp_kernels.wsb_dp_scores_dense, dp_kernels.wsb_dp_scores_dense_reference
    return _check_equal(f"{kernel} mesh shard{' tree' if tree else ''}",
                        fn(S, n, tp.lt, *args, index._locality, **kw),
                        ref(S, n, tp.lt, *args, index._locality), list(S.shape))


def phase_mesh_dense(ctx, card):
    """4m, contextual and tree: 4f's contextual find_batch Q=32 (affine
    and ExponentialGapCost(3.0)) and 4h's mixed tree (affine) on the
    CTX_SENTENCES-sentence session over the mesh, each byte-identical to its
    single-device batch and timed against it in turns; the dense entries
    on one shard's inputs against their plain versions.  Returns as
    ``phase_mesh_static``."""
    from vectorian_tpu_torch.alignment import ExponentialGapCost, LocalAlignment
    from vectorian_tpu_torch.metrics import EmbeddingTokenSim, OptimizedSpanSim
    from vectorian_tpu_torch.sim.modifier import MixedTokenSimilarity

    session, queries = ctx["session"], ctx["queries"]
    ms = _mesh_ms()
    out = {"launches": {}, "err": {}}
    c, q = session.embeddings
    mixed = MixedTokenSimilarity([EmbeddingTokenSim(q), EmbeddingTokenSim(c)], [0.5, 0.5])
    cases = (("contextual affine", make_index(session), "affine_dp[dense]", False),
             ("contextual general", make_index(session, ExponentialGapCost(3.0)),
              "wsb_dp[dense]", False),
             ("tree affine", session.partition("sentence").index(
                 OptimizedSpanSim(mixed, LocalAlignment())), "affine_dp[dense]", True))
    kw = dict(n=10, min_score=0.2)
    for label, index, kernel, tree in cases:
        r = _mesh_twins(label, lambda: index.find_batch(queries, mesh=ms, **kw),
                        lambda: index.find_batch(queries, **kw))
        if not r["launches"].get(kernel):
            raise AssertionError(f"4m {label}: the mesh launched no {kernel}")
        for k, v in r["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        err = _mesh_dense_check(index, ms, queries, kernel, tree)
        out["err"][kernel] = max(out["err"].get(kernel, 0.0), err)
    return out


# the wrappers a paged pass launches its kernels through (imported into
# ops/search), held against their plain versions on their first call
PAGED_WRAPPERS = ("affine_dp_scores", "wsb_dp_scores", "affine_dp_scores_dense",
                  "wsb_dp_scores_dense", "affine_dp_scores_rows", "wsb_dp_scores_rows")


_DENSE_WRAPPERS = {"affine_dp_scores_dense": "affine_dp[dense]",
                   "wsb_dp_scores_dense": "wsb_dp[dense]"}


class _FirstCalls:
    """Records the first call of each of ``PAGED_WRAPPERS`` made through
    ops/search while installed (its tensors cloned: a paged bucket's are
    evicted after its pass) — the first bucket a paged pass launched a
    kernel on."""

    def __init__(self):
        from vectorian_tpu_torch.ops import search

        self.search = search
        self.orig = {n: getattr(search, n) for n in PAGED_WRAPPERS}
        self.calls = {}

    def __enter__(self):
        import torch

        def keep(x):
            return x.clone() if isinstance(x, torch.Tensor) else x

        def wrap(name, real):
            def fn(*args, **kw):
                if name not in self.calls:
                    tags = kw.get("tags")
                    if tags is not None:
                        tags = type(tags)(*(keep(t) for t in tags))
                    self.calls[name] = ([keep(a) for a in args],
                                        {**{k: keep(v) for k, v in kw.items()},
                                         **({"tags": tags} if "tags" in kw else {})})
                return real(*args, **kw)
            return fn

        for name, real in self.orig.items():
            setattr(self.search, name, wrap(name, real))
        return self

    def __exit__(self, *exc):
        for name, real in self.orig.items():
            setattr(self.search, name, real)

    def check(self, label):
        """Each recorded launch again, the kernel against its plain version
        bit for bit (a dense entry's on every route its plan takes there):
        {wrapper: max |diff|}."""
        from vectorian_tpu_torch.ops import dp_kernels

        if not self.calls:
            raise AssertionError(f"{label}: the paged pass launched no kernel")
        out = {}
        for name, (args, kw) in self.calls.items():
            ref_kw = {k: v for k, v in kw.items()
                      if k not in ("host_costs", "_route", "len_t_host")}
            ref_args = args
            if isinstance(args[0], (dp_kernels.AffineTable, dp_kernels.WsbTable)):
                # the pass's prepared table reads the len_t it was made from
                args = [args[0], *args[1:3], args[0].len_t, *args[4:]]
                ref_args = [args[0].table, *args[1:]]
            fn = getattr(dp_kernels, name)
            want = getattr(dp_kernels, name + "_reference")(*ref_args, **ref_kw)
            out[name] = _check_equal(f"{label} {name}", fn(*args, **kw), want,
                                     tuple(want.shape))
            kernel = _DENSE_WRAPPERS.get(name)
            if kernel is not None:
                # every other route the dense plan takes at this block, forced
                S = args[0]
                registers = kernel.startswith("affine") or dp_kernels._register_costs(
                    S.shape[1], S.shape[2], S, args[3:6], kw.get("host_costs")) is not None
                for f in dense_routes(kernel, S, registers)[1]:
                    got = fn(*args, **{**kw, "_route": f})
                    out[name] = max(out[name], _check_equal(
                        f"{label} {name} {f}", got, want, tuple(want.shape)))
        return out


def peak_and_bytes(engine, fn):
    """(fn's result, the device memory its call peaked at above what was
    allocated before it, bytes, and the host -> device bytes it uploaded)."""
    import torch

    torch.cuda.synchronize()
    # frees the blocks an earlier call released behind stream events
    # (record_stream), which the allocator would count until its next malloc
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    up = engine.uploaded_bytes
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base, engine.uploaded_bytes - up


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def htod_overlap(label, fn):
    """A torch.profiler trace of ``fn`` (device activity only): the host ->
    device copies' device ms, the part of it that ran while a kernel ran
    (on the compute stream), the kernels' busy ms, the wall ms, the events
    by category and the longest copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # the copies' device ms as key_averages sums them, beside the trace's
    htod_avg = sum(e.self_device_time_total for e in prof.key_averages()
                   if "HtoD" in e.key) / 1e3
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.load(open(f.name)).get("traceEvents", [])
    copies, kernels, cats, longest = [], [], {}, []
    for e in events:
        if "dur" not in e:
            continue
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") == "kernel":
            kernels.append(span)
        elif "memcpy" in str(e.get("cat")).lower():
            longest.append((float(e["dur"]) / 1e3, e.get("name", "")[:40]))
            if "HtoD" in e.get("name", ""):
                copies.append(span)
    busy = _union(kernels)
    over = sum(max(0.0, min(b, kb) - max(a, ka)) for a, b in copies for ka, kb in busy)
    htod = sum(b - a for a, b in copies)
    res = {"call": label, "wall_ms": wall_ms, "htod_copies": len(copies),
           "htod_ms": htod / 1e3, "htod_under_kernels_ms": over / 1e3,
           "htod_under_kernels_share": over / htod if htod else None,
           "kernel_busy_ms": sum(b - a for a, b in busy) / 1e3,
           "events_by_category": cats, "longest_copies_ms": sorted(longest)[-3:],
           "htod_ms_key_averages": htod_avg}
    emit({"phase": "paged_profile", **res})
    return res


def paged_twin(session, make):
    """``make()``'s index bound to a paged engine over the session's own
    packing of its sentences (no new packing); the session keeps its
    resident engine."""
    from vectorian_tpu_torch.ops.search import BruteForceEngine

    spec = session.partition("sentence").spec
    resident = session.engine(spec)
    session._engine_cache[spec] = BruteForceEngine(
        session.packed_corpus(spec), DEVICE, paged=True)
    try:
        return make()
    finally:
        session._engine_cache[spec] = resident


# 4l's multi-bucket corpora: each bucket of a packing cut into this many
# row ranges of the same capacity (phase 4's and 4f's 9-token sentences
# pack into one bucket each, which bypasses the double buffering)
SPLIT_BUCKETS = 8


def split_packing(packed, k):
    """(``packed`` with each bucket cut into ``k`` row ranges of its
    capacity, the (bucket, r0, r1) of each new bucket): the same slices
    and arrays in ``k`` times the buckets."""
    import dataclasses

    import numpy as np

    buckets, ranges = [], []
    for bi, b in enumerate(packed.buckets):
        edges = np.linspace(0, b.n, k + 1).astype(np.int64)
        for r0, r1 in zip(edges[:-1].tolist(), edges[1:].tolist()):
            if r1 > r0:
                buckets.append(dataclasses.replace(
                    b, token_ids=b.token_ids[r0:r1], pos_ids=b.pos_ids[r0:r1],
                    tag_ids=b.tag_ids[r0:r1], lengths=b.lengths[r0:r1],
                    slice_index=b.slice_index[r0:r1]))
                ranges.append((bi, r0, r1))
    return dataclasses.replace(packed, buckets=buckets), ranges


def split_twins(session, make, stores=None):
    """(resident, paged) indexes of ``make()`` bound to engines over the
    session's packing cut by ``split_packing`` into SPLIT_BUCKETS buckets a
    length; ``stores``: {paged: {name: per-bucket stores}} of engines over
    the uncut packing, whose row ranges become the new engines' stores (no
    second build)."""
    from vectorian_tpu_torch.ops.search import BruteForceEngine

    spec = session.partition("sentence").spec
    split, ranges = split_packing(session.packed_corpus(spec), SPLIT_BUCKETS)
    own = session.engine(spec)
    out = []
    for paged in (False, True):
        eng = BruteForceEngine(split, DEVICE, paged=paged)
        for name, parts in (stores or {}).get(paged, {}).items():
            eng._ctx_stores[name] = [parts[bi][r0:r1] for bi, r0, r1 in ranges]
        session._engine_cache[spec] = eng
        try:
            out.append(make())
        finally:
            session._engine_cache[spec] = own
    return tuple(out)


def _paged_split(label, session, make, queries, finds, precision=None, stores=None):
    """4l over several buckets: ``_paged_vs_resident`` of ``split_twins``
    and a torch.profiler split of a paged find_batch (the share of the
    copies under kernels, which the double buffering exists for); with
    ``stores``, the paged pass's peak above the resident one's in units
    of the largest bucket's store (about two when bucket i+1 is paged in
    while bucket i is read)."""
    resident, paged = split_twins(session, make, stores)
    res = _paged_vs_resident(label, resident, paged, queries, finds, precision)
    res["buckets"] = len(paged._engine._device_buckets)
    res["profile"] = htod_overlap(f"paged {label} find_batch", lambda: (
        paged.find_batch(queries, n=10, min_score=0.2, sim_precision=precision)))
    if stores:
        largest = max(sum(st[db["bi"]].numel() * st[db["bi"]].element_size()
                          for st in paged._engine._ctx_stores.values())
                      for db in paged._engine._device_buckets)
        res["largest_bucket_store_bytes"] = largest
        res["peak_over_resident_in_buckets"] = (
            res["paged"]["peak_bytes_find_batch"]
            - res["resident"]["peak_bytes_find_batch"]) / largest
    return res


def _paged_vs_resident(label, resident, paged, queries, finds, precision=None, reps=3):
    """find p50 (of the finds) and find_batch ms (median of ``reps``) of a
    resident and a paged index in the same call, byte for byte equal; the
    paged engine's peak device memory and uploaded bytes a find_batch, and
    a resident find_batch's peak; the paged kernels' launches (counts from
    0) and each first launch against its plain version."""
    import numpy as np

    from vectorian_tpu_torch.ops import dp_kernels

    res = {}
    got = {}
    for name, ix in (("resident", resident), ("paged", paged)):
        ix.find_batch(queries[:2], n=10, min_score=0.2, sim_precision=precision)  # warm
        walls, ts, found = [], [], []
        dp_kernels.reset_launches()
        with _FirstCalls() as first:
            for _ in range(reps):
                t = time.perf_counter()
                batch = ix.find_batch(queries, n=10, min_score=0.2, sim_precision=precision)
                walls.append((time.perf_counter() - t) * 1e3)
            for q in finds:
                t = time.perf_counter()
                found.append(pairs(ix.find(q, n=10, min_score=0.2)))
                ts.append((time.perf_counter() - t) * 1e3)
        launches = {k: v for k, v in dp_kernels.LAUNCHES.items() if v}
        got[name] = [pairs(r) for r in batch] + found
        _, peak, up = peak_and_bytes(ix._engine, lambda: ix.find_batch(
            queries, n=10, min_score=0.2, sim_precision=precision))
        res[name] = {"find_batch_ms_median": float(np.median(walls)), "find_batch_ms": walls,
                     "find_p50_ms": float(np.median(ts)) if ts else None,
                     "peak_bytes_find_batch": peak, "htod_bytes_find_batch": up}
        if name == "paged":
            if not launches:
                raise AssertionError(f"4l {label}: the paged path launched no kernel")
            res[name]["launches"] = launches
            res[name]["first_bucket_vs_plain"] = first.check(f"4l {label}")
    if got["paged"] != got["resident"] or not any(got["paged"]):
        raise AssertionError(f"4l {label}: paged != resident")
    res["paged_equals_resident"] = True
    return res


def phase_paged_static(session, queries, finds, card):
    """4l (static): a paged engine over phase 4's packed corpus (1M
    slices) against the resident one in the same call: affine and general
    find p50 (of 21) and find_batch Q=32 at int8, byte for byte; peak device
    memory and host -> device bytes a pass; each kernel's first launch on
    the paged path against its plain version; a torch.profiler split of a
    paged find_batch (how much of the copies ran under kernels); one
    relaxed-WMD find_batch paged against resident.  Returns the paged
    launches by kernel."""
    from vectorian_tpu_torch.alignment import ExponentialGapCost, WordMoversDistance

    res, launches = {}, {}
    for label, gap in (("affine", None), ("general", ExponentialGapCost(3.0))):
        resident = make_index(session, gap)
        paged = paged_twin(session, lambda: make_index(session, gap))
        res[label] = _paged_vs_resident(label, resident, paged, queries, finds, "int8")
        for k, v in res[label]["paged"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
        res[label]["profile"] = htod_overlap(f"paged find_batch {label}", lambda: (
            paged.find_batch(queries, n=10, min_score=0.2)))
    # one relaxed-WMD batch a mode (4k times the resident one in 3)
    resident = _transport_index(session, WordMoversDistance())
    paged = paged_twin(session, lambda: _transport_index(session, WordMoversDistance()))
    out = {}
    for name, ix in (("resident", resident), ("paged", paged)):
        (batch, wall), peak, up = peak_and_bytes(ix._engine, lambda: _timed(
            lambda: ix.find_batch(queries, n=10, min_score=0.2)))
        out[name] = {"find_batch_ms": wall, "peak_bytes": peak, "htod_bytes": up,
                     "pairs": [pairs(r) for r in batch]}
    if out["paged"].pop("pairs") != out["resident"].pop("pairs"):
        raise AssertionError("4l rwmd: paged != resident")
    res["rwmd"] = out
    # its profile on 8 queries (a Q=32 batch's trace is ~70,000 kernels)
    res["rwmd"]["profile_q8"] = htod_overlap("paged rwmd find_batch Q=8", lambda: (
        paged.find_batch(queries[:8], n=10, min_score=0.2)))
    res["split"] = _paged_split(f"split{SPLIT_BUCKETS} affine", session,
                                lambda: make_index(session), queries, finds, "int8")
    for k, v in res["split"]["paged"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    emit({"phase": "paged", "corpus": "phase 4 (1M slices)", **res, "card": card})
    return launches


def phase_paged_contextual(ctx, card):
    """4l (contextual): a paged engine over 4f's packing (CTX_SENTENCES
    sentences) with its bf16 store in pinned host memory, against 4f's
    resident engine in the same call: find_batch Q=32 (affine and
    general), byte for byte, the peak device memory and uploaded bytes a
    pass beside the resident store's bytes, the dense kernels' first
    launches against their plain versions, and a torch.profiler split of a
    paged find_batch.  Returns the paged launches by kernel."""
    import torch

    from vectorian_tpu_torch.alignment import ExponentialGapCost

    session, queries, finds = ctx["session"], ctx["queries"], ctx["finds"]
    res, launches = {}, {}
    for label, gap in (("affine", None), ("general", ExponentialGapCost(3.0))):
        resident = make_index(session, gap)
        paged = paged_twin(session, lambda: make_index(session, gap))
        if label == "affine":
            t = time.perf_counter()
            paged._engine.ensure_contextual("ctx", session.documents, session._ctx_dims["ctx"])
            res["paged_store_build_s"] = time.perf_counter() - t
            store = paged._engine._ctx_stores["ctx"]
            if DEVICE != "cpu" and any(t.is_cuda or not t.is_pinned() for t in store):
                raise AssertionError("4l: a paged store is not in pinned host memory")
            res["store_bytes"] = sum(t.numel() * t.element_size() for t in store)
            res["largest_bucket_store_bytes"] = max(t.numel() * t.element_size() for t in store)
        res[label] = _paged_vs_resident(f"ctx {label}", resident, paged, queries, finds[:4])
        for k, v in res[label]["paged"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
        res[label]["profile"] = htod_overlap(f"paged ctx find_batch {label}", lambda: (
            paged.find_batch(queries, n=10, min_score=0.2)))
        torch.cuda.empty_cache()
    # several buckets: the stores' row ranges, resident and pinned
    stores = {False: resident._engine._ctx_stores, True: paged._engine._ctx_stores}
    res["split"] = _paged_split(f"ctx split{SPLIT_BUCKETS} affine", session,
                                lambda: make_index(session), queries, finds[:4],
                                stores=stores)
    for k, v in res["split"]["paged"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    emit({"phase": "paged_contextual", "sentences": CTX_SENTENCES, **res, "card": card})
    return launches


def phase_paged_ties(card):
    """4l (ties): 4c's tie-heavy corpus on a paged engine: every cut is
    unsafe, so the extras round selects columns of buckets already
    released and pages them in again; the results are the resident
    engine's bytes (affine and general gaps, int8 and f32 find_batch, and
    find) and, within 1e-6, the CPU's; the re-pages counted, each kernel's
    first launch on the paged path against its plain version."""
    import numpy as np

    from vectorian_tpu_torch.alignment import ExponentialGapCost
    from vectorian_tpu_torch.ops import dp_kernels, search

    rng = np.random.default_rng(SEED + 3)
    words, texts, queries = duplicates_corpus(rng)
    vectors = rng.normal(size=(len(words), 300)).astype(np.float32)
    session = build_session(texts, words, vectors, DEVICE)
    on_cpu = build_session(texts, words, vectors, "cpu")
    real = search.BucketTopKSource._bucket_scores
    repaged = [0]

    def counted(self, bi):
        if isinstance(self._pending[bi][1], search._LazyScores):
            repaged[0] += 1
        return real(self, bi)

    res, launches = {}, {}
    search.BucketTopKSource._bucket_scores = counted
    try:
        for label, gap in (("affine", None), ("general", ExponentialGapCost(3.0))):
            resident = make_index(session, gap)
            paged = paged_twin(session, lambda: make_index(session, gap))
            got = {}
            for name, ix in (("resident", resident), ("paged", paged),
                             ("cpu", make_index(on_cpu, gap))):
                repaged[0] = 0
                dp_kernels.reset_launches()
                with _FirstCalls() as first:
                    got[name] = [pairs(r) for prec in ("int8", "float32") for r in
                                 ix.find_batch(queries, n=10, min_score=0.1,
                                               sim_precision=prec)]
                    got[name] += [pairs(ix.find(q, n=10, min_score=0.1)) for q in queries[:4]]
                if name == "paged":
                    res[label] = {"repaged_buckets": repaged[0],
                                  "launches": {k: v for k, v in dp_kernels.LAUNCHES.items()
                                               if v},
                                  "first_bucket_vs_plain": first.check(f"4l ties {label}")}
            if got["paged"] != got["resident"] or not any(got["paged"]):
                raise AssertionError(f"4l ties {label}: paged != resident")
            res[label]["max_abs_score_diff_vs_cpu"] = compare_with_cpu(
                f"4l ties {label}", got["paged"], got["cpu"])
            if not res[label]["repaged_buckets"]:
                raise AssertionError(f"4l ties {label}: no extras round re-paged a bucket")
            for k, v in res[label]["launches"].items():
                launches[k] = launches.get(k, 0) + v
    finally:
        search.BucketTopKSource._bucket_scores = real
    emit({"phase": "paged_ties", "sentences": 3_000, **res, "card": card})
    return launches


def phase_small_reference(long_q):
    """The port on the card against the port on the CPU, small corpus,
    affine and general-gap indexes; then phase 4's long query (find, and a
    find_batch that holds it)."""
    import numpy as np

    from vectorian_tpu_torch.alignment import ExponentialGapCost

    rng = np.random.default_rng(SEED + 1)
    words, texts, query = zipf_corpus(4_000, rng)
    vectors = rng.normal(size=(len(words), 300)).astype(np.float32)
    qs = [query() for _ in range(8)]
    on_card = build_session(texts, words, vectors, DEVICE)
    on_cpu = build_session(texts, words, vectors, "cpu")
    worst = {}
    for label, gap in (("affine", None), ("general", ExponentialGapCost(3.0))):
        a = [pairs(r) for r in make_index(on_card, gap).find_batch(qs, n=10, min_score=0.1)]
        b = [pairs(r) for r in make_index(on_cpu, gap).find_batch(qs, n=10, min_score=0.1)]
        worst[label] = compare_with_cpu(f"small reference {label}", a, b)
        card_idx, cpu_idx = make_index(on_card, gap), make_index(on_cpu, gap)
        a = [pairs(card_idx.find(long_q, n=10, min_score=0.01))] + [
            pairs(r) for r in card_idx.find_batch([long_q] + qs, n=10, min_score=0.01)]
        b = [pairs(cpu_idx.find(long_q, n=10, min_score=0.01))] + [
            pairs(r) for r in cpu_idx.find_batch([long_q] + qs, n=10, min_score=0.01)]
        if not a[0] or a[0] != a[1]:
            raise AssertionError(f"small reference {label}: long query find and find_batch differ")
        worst[f"{label}_long_query"] = compare_with_cpu(f"small reference {label} long", a, b)
        # 4e's options, find_batch at each of their precisions and a find
        for name, span, kw, precisions in _option_cases(words):
            card_idx = make_index(on_card, gap, **span)
            cpu_idx = make_index(on_cpu, gap, **span)
            for prec in precisions:
                a = [pairs(r) for r in card_idx.find_batch(
                    qs, n=10, min_score=0.1, sim_precision=prec, **kw)]
                b = [pairs(r) for r in cpu_idx.find_batch(
                    qs, n=10, min_score=0.1, sim_precision=prec, **kw)]
                a.append(pairs(card_idx.find(qs[0], n=10, min_score=0.1, **kw)))
                b.append(pairs(cpu_idx.find(qs[0], n=10, min_score=0.1, **kw)))
                if not any(a) or a[-1] != a[0]:
                    raise AssertionError(f"small reference {label} {name}: find and "
                                         "find_batch differ")
                worst[f"{label}_{name}_{prec or 'int8'}"] = compare_with_cpu(
                    f"small reference {label} {name}", a, b)
    emit({"phase": "small_reference", "queries": len(qs),
          "long_query_tokens": len(long_q.split()),
          "max_abs_score_diff_vs_cpu": worst})


# 4n: the renders' spec, and the stored corpus's size in the full run (the
# first CORPUS_SENTENCES of phase 4's sentences: the full run takes about
# 930 s of the 1,200 s limit on an H100 at 700 W without this part, which
# costs about one more host build, so it is cut to a quarter of phase 4's
# corpus)
RENDER_SPEC = "excerpt +tags +metric, flow, matrix"
CORPUS_SENTENCES = 250_000


def missing(package):
    """True, after a line that names what does not run and why, when
    ``package`` is not installed; nothing else is caught."""
    if importlib.util.find_spec(package) is not None:
        return False
    emit({"phase": "notebook", "not_run": f"{package} not installed",
          "part": {"h5py": "the stored corpus (Corpus / TemporaryCorpus)",
                   "ipywidgets": "InteractiveQuery; LabSession without its progress bar"}[
                       package]})
    log(f"4n: {package} is not installed; its part does not run")
    return True


def _slice_tokens(match):
    pd = match.prepared_doc
    doc = pd.doc
    start, length = match.slice_span
    return [doc.text[doc.idx[o] : doc.idx[o] + doc.len_[o]]
            for o in pd.orig_index[start : start + length]]


def render_check(label, results, card, svg):
    """4n: ``Result.format(RENDER_SPEC)._repr_html_()`` of each result, timed
    on the host (the card does no work in a render); per result one excerpt
    box and one flow box a match, the flow SVG's paths = the match's flow
    edges (``flow_edges``), one matrix spec a match, and each match's
    excerpt, holding its slice's text, in the page.  ``svg``: the flow
    renders take the inline SVG branch (holoviews is not installed)."""
    import html as html_mod

    import numpy as np

    from vectorian_tpu_torch.render import ExcerptRenderer, flow_edges

    ms, n_matches, n_edges = [], 0, 0
    for r in results:
        t = time.perf_counter()
        page = r.format(RENDER_SPEC)._repr_html_()
        ms.append((time.perf_counter() - t) * 1e3)
        body = html_mod.unescape(page)  # the srcdoc's page
        edges = sum(len(list(flow_edges(m.flow))) for m in r)
        if body.count("<div class='box'>") != 2 * len(r):
            raise AssertionError(f"render {label}: not one excerpt and one flow box a match")
        if svg and body.count("<path ") != edges:
            raise AssertionError(f"render {label}: {body.count('<path ')} SVG paths, "
                                 f"{edges} flow edges")
        if body.count("vegaEmbed('#vtpu-matrix-") != len(r):
            raise AssertionError(f"render {label}: not one matrix spec a match")
        for m in r:
            box = ExcerptRenderer("tags", "metric").render_match(m.to_json(10), m.doc.title)
            if box not in body or not all(html_mod.escape(w) in box for w in _slice_tokens(m)):
                raise AssertionError(f"render {label}: slice {m.slice_id}'s text is not "
                                     "in its excerpt")
        n_matches += len(r)
        n_edges += edges
    if not n_matches:
        raise AssertionError(f"render {label}: no match rendered")
    emit({"phase": "notebook_render", "results": label, "card": card, "n": len(results),
          "matches": n_matches, "flow_edges": n_edges, "spec": RENDER_SPEC,
          "svg_paths_checked": svg, "host_ms_per_result_p50": float(np.percentile(ms, 50)),
          "host_ms_per_result_max": max(ms)})


def phase_notebook_render(session, queries, finds, card):
    """4n, on phase 4's session: the renders of the 21 affine ``find``
    results, of one int8 ``find_batch`` of the 32 queries under the affine
    and the ``ExponentialGapCost(3.0)`` index, and of 4i's relaxed-WMD
    ``find`` results (sparse flows); the kernels' launch counts set to 0
    right before the searches and read right after."""
    from vectorian_tpu_torch.alignment import ExponentialGapCost, WordMoversDistance
    from vectorian_tpu_torch.ops import dp_kernels

    n, min_score = 10, 0.2
    affine, general = make_index(session), make_index(session, ExponentialGapCost(3.0))
    rwmd = _transport_index(session, WordMoversDistance())
    dp_kernels.reset_launches()
    groups = {
        "find_affine": [affine.find(q, n=n, min_score=min_score) for q in finds],
        "find_batch_int8_affine": affine.find_batch(queries, n=n, min_score=min_score),
        "find_batch_int8_general": general.find_batch(queries, n=n, min_score=min_score),
        "find_relaxed_wmd": [rwmd.find(q, n=n, min_score=min_score) for q in finds],
    }
    launches = {k: v for k, v in dp_kernels.LAUNCHES.items() if v}
    for kernel in ("affine_dp", "affine_dp[int8]", "wsb_dp[int8]"):
        if not launches.get(kernel):
            raise AssertionError(f"4n: the searches launched no {kernel} kernel")
    svg = importlib.util.find_spec("holoviews") is None
    if not svg:
        emit({"phase": "notebook", "not_run": "the SVG path count: holoviews renders the flows"})
    for label, results in groups.items():
        check_results(results, n, min_score)
        render_check(label, results, card, svg)
    emit({"phase": "notebook_searches", "card": card, "launches": launches})


def phase_lab_session(texts, words, vectors, plain, finds, card):
    """4n: a ``LabSession`` over the 3,000-sentence cut on the card:
    ``run_query(find, q)`` returns the plain ``Session``'s (slice_id, score)
    lists byte for byte, and kernel 1 launched (counts from 0)."""
    import vectorian_tpu_torch as vt
    from vectorian_tpu_torch.ops import dp_kernels

    lab = build_session(corpus_cut(texts), words, vectors, DEVICE, cls=vt.LabSession)
    lab_index, plain_index = make_index(lab), make_index(plain)
    dp_kernels.reset_launches()
    got = [pairs(lab.run_query(lambda q: lab_index.find(q, n=10, min_score=0.2), q))
           for q in finds]
    launched = dp_kernels.LAUNCHES["affine_dp"]
    want = [pairs(plain.run_query(lambda q: plain_index.find(q, n=10, min_score=0.2), q))
            for q in finds]
    if not launched:
        raise AssertionError("LabSession.run_query launched no affine_dp kernel")
    if got != want or not any(got):
        raise AssertionError("LabSession.run_query differs from Session.run_query")
    emit({"phase": "notebook_lab_session", "card": card, "queries": len(finds),
          "affine_dp_launches": launched, "byte_identical": True,
          "progress_bar": not missing("ipywidgets")})


def phase_interactive(session, finds, card):
    """4n, where ipywidgets is installed: ``InteractiveQuery`` on the cut's
    card session; ``run`` under an affine and a general-gap configuration
    equals the configured index's ``find`` byte for byte (kernel 1, then
    kernel 3, launched), and ``QueryWidget.search_html()`` renders."""
    if missing("ipywidgets"):
        return
    from vectorian_tpu_torch.interact import InteractiveQuery
    from vectorian_tpu_torch.ops import dp_kernels

    iq = InteractiveQuery(session)
    for gap, kernel in (("constant", "affine_dp"), ("exponential", "wsb_dp")):
        iq._alignment._gap_s._kind.value = gap
        iq._alignment._gap_t._kind.value = gap
        dp_kernels.reset_launches()
        got = [pairs(iq.run(q, n=10)) for q in finds]
        launched = dp_kernels.LAUNCHES[kernel]
        index = iq.make_index()
        if not launched or got != [pairs(index.find(q, n=10)) for q in finds]:
            raise AssertionError(f"InteractiveQuery.run ({gap} gaps) differs from find "
                                 f"or launched no {kernel} kernel")
        emit({"phase": "notebook_interactive", "card": card, "gap": gap,
              "description": iq.describe(), "launches": {kernel: launched},
              "byte_identical": True})
    iq._query._text.value = finds[0]
    page = iq._query.search_html()
    if "<iframe" not in page:
        raise AssertionError("QueryWidget.search_html rendered no page")
    emit({"phase": "notebook_interactive", "card": card, "search_html_chars": len(page)})


def phase_corpus(texts, words, vectors, build, queries, finds, card, n_sents):
    """4n, where h5py is installed: a ``TemporaryCorpus`` of the first
    ``n_sents`` sentences of ``texts`` (documents of 2,000 sentences), a
    cold ``Session(corpus)`` (prepare, store the flavor, pack) and a second
    session over the same directory reopened as ``Corpus(path)`` (the flavor
    hit: ``prepare_document`` counted and required to be 0; the packing from
    the packed-corpus cache); ``find`` p50 (21) and an int8 ``find_batch``
    Q=32 on both, byte-identical; add, cold and reopen seconds beside
    ``build``, the (sentences, seconds) of the run's host build."""
    if missing("h5py"):
        return
    import numpy as np

    import vectorian_tpu_torch as vt
    import vectorian_tpu_torch.session as session_mod
    from vectorian_tpu_torch.ops import dp_kernels

    emb = vt.KeyedVectors("syn", words, vectors)
    real, prepared = session_mod.prepare_document, [0]

    def counting(*args, **kwargs):
        prepared[0] += 1
        return real(*args, **kwargs)

    def searches(session):
        index = make_index(session)
        dp_kernels.reset_launches()
        lats, found = [], []
        for q in finds:
            t = time.perf_counter()
            found.append(pairs(index.find(q, n=10, min_score=0.2)))
            lats.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        batch = [pairs(r) for r in index.find_batch(queries, n=10, min_score=0.2)]
        batch_ms = (time.perf_counter() - t) * 1e3
        launches = {k: dp_kernels.LAUNCHES[k] for k in ("affine_dp", "affine_dp[int8]")}
        if not all(launches.values()) or not any(batch):
            raise AssertionError(f"4n corpus: the searches launched {launches}")
        return found + batch, float(np.percentile(lats, 50)), batch_ms, launches

    docs = corpus_cut(texts, n_sents)
    session_mod.prepare_document = counting
    try:
        with vt.TemporaryCorpus() as corpus:
            t = time.perf_counter()
            importer = vt.StringImporter()
            for i, text in enumerate(docs):
                corpus.add_doc(importer(text, title=f"d{i}"))
            add_s = time.perf_counter() - t
            t = time.perf_counter()
            cold = vt.Session(corpus, embeddings=[emb], device=DEVICE)
            make_index(cold).packed
            cold_s = time.perf_counter() - t
            cold_prepared = prepared[0]
            want = searches(cold)
            del cold
            with vt.Corpus(corpus.path) as again:
                prepared[0] = 0
                t = time.perf_counter()
                warm = vt.Session(again, embeddings=[emb], device=DEVICE)
                reopen_session_s = time.perf_counter() - t
                make_index(warm).packed
                reopen_s = time.perf_counter() - t
                if prepared[0]:
                    raise AssertionError(f"4n corpus: the reopened corpus prepared "
                                         f"{prepared[0]} documents (no flavor hit)")
                got = searches(warm)
                del warm
    finally:
        session_mod.prepare_document = real
    if got[0] != want[0]:
        raise AssertionError("4n corpus: the reopened session's lists differ from the cold one's")
    emit({"phase": "notebook_corpus", "card": card, "sentences": n_sents, "documents": len(docs),
          "add_s": add_s, "cold_s": cold_s, "cold_prepared_documents": cold_prepared,
          "reopen_s": reopen_s, "reopen_session_s": reopen_session_s,
          "reopen_prepared_documents": 0, "host_build_sentences": build[0],
          "host_build_s": build[1],
          "reopen_share_of_cold": reopen_s / cold_s,
          "find_p50_ms": {"cold": want[1], "reopened": got[1]},
          "find_batch_int8_ms": {"cold": want[2], "reopened": got[2]},
          "launches": {"cold": want[3], "reopened": got[3]}, "byte_identical": True})


def main(old_tree=None):
    if not (ROOT / "vectorian_tpu_torch" / "csrc" / "affine_dp.cu").exists():
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch

    global OLD
    if old_tree is not None:
        OLD = load_old_tree(old_tree)
    t_start = time.perf_counter()
    card = phase_device()
    kind = torch.cuda.get_device_name(0)
    log(f"device {card}")
    import vectorian_tpu_torch  # noqa: F401  (sets exact-f32 matmul flags)

    # the packed-corpus cache of this run's own (no earlier run's file counts)
    cache = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    os.environ["VECTORIAN_CACHE_HOME"] = cache
    try:
        kernels = run_phases(card)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    log(f"done in {time.perf_counter() - t_start:.0f} s")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


def run_phases(card):
    """Phases 2-5; returns the kernels' line."""
    import numpy as np

    phase_build()
    log("built")
    worst = phase_kernels()
    worst_general = phase_kernels_general()
    long = phase_kernels_long()
    log("phase 3 long shapes done")
    wide_general = phase_kernels_wide_general()
    log("phase 3 wide general-gap shapes done")
    worst_rows = phase_kernels_rows()
    worst_quant = phase_kernels_quant()
    quant = quant_turns()
    log("phase 3 rows and 3b done")
    worst_wide = phase_kernels_wide()
    worst_tagged = phase_kernels_tagged()
    worst_dense = phase_kernels_dense()
    log("kernels match their plain versions")

    rng = np.random.default_rng(SEED)
    words, texts, query = zipf_corpus(SENTENCES, rng)
    vectors = rng.normal(size=(len(words), 300)).astype(np.float32)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fasttext_") as tmp:
        ft, ft_info = fasttext_model(texts, np.random.default_rng(SEED + 7), tmp)
    log(f"fastText .bin written in {ft_info['write_s']:.1f} s, loaded in {ft_info['load_s']:.1f} s")
    t0 = time.perf_counter()
    session = build_session(texts, words, vectors, DEVICE, extra=[ft])
    n_slices = make_index(session).packed.n_slices
    t_build = time.perf_counter() - t0
    emit({"phase": "host_build", "sentences": SENTENCES, "slices": n_slices,
          "host_build_s": t_build,
          "embeddings": [e.name for e in session.embeddings], "packed_cache": "cold"})
    log(f"host build {t_build:.1f} s, {n_slices} slices")
    queries = [query() for _ in range(32)]
    finds = [query() for _ in range(21)]
    long_q = query(160)
    from vectorian_tpu_torch.alignment import ExponentialGapCost

    affine = phase_main_path(session, None, "main_path", queries, finds, card, SENTENCES)
    log("main path done")
    general = phase_main_path(session, ExponentialGapCost(3.0), "general_path",
                              queries, finds, card, SENTENCES)
    log("general-gap main path done")
    options = phase_options(session, words, queries, finds, card)
    log("options done")
    wide = phase_long_query(session, long_q, queries, card)
    log("long-query path done")
    wide_path = phase_long_query_general(session, long_q, queries, card)
    log("general long-query path done")
    phase_fasttext(session, ft, queries, finds, np.random.default_rng(SEED + 8), card, ft_info)
    log("fastText path done")
    qft, qft_info = compress_fasttext(ft)
    log(f"fastText compressed in {qft_info['compress_s']:.1f} s")
    phase_warmup(session, finds[0], card)
    phase_packed_cache(session, queries, card)
    log("warmup and packed cache done")
    phase_submatch_debug(session, queries, finds, card)
    log("submatch and debug done")
    cut = {dev: build_session(corpus_cut(texts), words, vectors, dev) for dev in (DEVICE, "cpu")}
    phase_transport(session, finds, cut, card)
    log("transport path done")
    tb = phase_transport_batch(session, queries, cut, card)
    log("transport batch done")
    mesh = phase_mesh_static(session, queries, finds, card)
    phase_mesh_transport(session, queries, tb)
    log("mesh static and transport done")
    phase_span(session, queries, finds, cut, card)
    log("span path done")
    paged_static = phase_paged_static(session, queries, finds, card)
    log("paged static path done")
    phase_notebook_render(session, queries, finds, card)
    phase_lab_session(texts, words, vectors, cut[DEVICE], finds, card)
    phase_interactive(cut[DEVICE], finds, card)
    log("renders, LabSession and InteractiveQuery done")
    del session, ft, cut
    phase_corpus(texts, words, vectors, (SENTENCES, t_build), queries, finds, card,
                 CORPUS_SENTENCES)
    log("stored corpus done")
    long_path = phase_long_path(words, vectors, card)
    log("length-mixed path done")
    rescore = phase_rescore(card)
    log("rescore path done")
    paged_ties = phase_paged_ties(card)
    log("paged ties done")
    dense, ctx = phase_contextual(card, qft)
    log("contextual path done")
    tree = phase_config4(ctx, qft, qft_info, card)
    log("config 4 path done")
    phase_transport_tree(ctx, card)
    log("transport tree batch done")
    mesh_dense = phase_mesh_dense(ctx, card)
    log("mesh contextual and tree done")
    paged_ctx = phase_paged_contextual(ctx, card)
    del ctx
    log("paged contextual path done")
    phase_small_reference(long_q)

    kernels = []
    for name, source, replaces, res, worst_p3 in (
        ("affine_dp", "affine_dp.cu", "vectorian_tpu/ops/pallas_dp.py:369",
         affine["affine_dp"], worst),
        ("wsb_dp", "wsb_dp.cu", "vectorian_tpu/ops/pallas_dp.py:155",
         general["wsb_dp"], worst_general["wsb_dp"]),
    ):
        kernels.append({
            "name": name, "route": "cuda", "launch_route": res["launch_route"],
            "source": f"vectorian_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": res["launches"], "max_abs_err": max(worst_p3, res["max_abs_err"]),
            "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None,
            "ms_find": res["ms_find"], "plain_ms_find": res["plain_ms_find"],
            "bound_ms_find": res["bound_ms_find"],
            "shapes_n_L_Tpad_Q": res["shapes_n_L_Tpad_Q"],
            "shapes_n_L_Tpad_Q_find": res["shapes_n_L_Tpad_Q_find"], "card": card,
        })
    # kernel 3's long route (buckets of 33-256 tokens): 4r's length-mixed
    # corpus; ms / plain / bound: its long buckets' launches of the f32
    # batch (Q 32), summed; the int8 batch and a find's Q 1 beside them
    kernels.append(long_route_line(long, long_path, card))
    # kernel 3's wide route (needles past 32 columns): the general long
    # query's pass on phase 4's 1M slices and 4r's prose-length batch
    kernels.append(wide_route_line(wide_general, wide_path, long_path["prose"], card))
    # the bf16 / int8 table variants of kernels 1 and 3 (find_batch's
    # quantized ranking passes; Pallas cast each row as it read it)
    for base, source, replaces, path in (
        ("affine_dp", "affine_dp.cu", "vectorian_tpu/ops/pallas_dp.py:369", affine),
        ("wsb_dp", "wsb_dp.cu", "vectorian_tpu/ops/pallas_dp.py:155", general),
    ):
        for tag in QUANT_TAGS.values():
            name = f"{base}[{tag}]"
            res = path[name]
            kernels.append({
                "name": name, "route": "cuda", "launch_route": res["launch_route"],
                "source": f"vectorian_tpu_torch/csrc/{source}", "replaces": replaces,
                "launches": res["launches"],
                "max_abs_err": max(worst_quant[name], res["max_abs_err"]),
                "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": None, "f32_ms": res["f32_ms"],
                "ms_old": quant[name]["main"].get("ms_old"),
                "device_turns": {label: {k: line.get(k) for k in (
                    "ms", "f32_ms", "ms_old", "bound_ms", "Tpad", "Q")}
                    for label, line in quant[name].items()},
                "shapes_n_L_Tpad_Q": res["shapes_n_L_Tpad_Q"], "card": card,
            })
    for name, source, replaces in (
        ("affine_dp_flat", "affine_dp.cu", "vectorian_tpu/ops/pallas_dp.py:44"),
        ("wsb_dp_flat", "wsb_dp.cu", "vectorian_tpu/ops/pallas_dp.py:155"),
    ):
        res = rescore[name]
        (err, ms, plain_ms, bound, by, after, before, columns, q_after,
         q_before) = time_row_calls(name, res)
        kernels.append({
            "name": name, "route": "cuda",
            "launch_route": (",".join(r for r in res["routes"] if r.startswith("rows_"))
                             if name == "wsb_dp_flat" else "thread_per_problem"),
            "entry": name.replace("_flat", "_scores_rows"),
            "source": f"vectorian_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": res["launches"], "max_abs_err": max(err, worst_rows[name]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
            "rounds": res["rounds"], "launches_per_round": res["per_round"],
            "round_ms": after, "round_ms_before": before,
            "queued_round_ms": q_after, "queued_round_ms_before": q_before,
            "columns_per_round": columns,
            "problems_per_call": [int(a[1].shape[0]) for _, a, _ in res["calls"]],
            "card": card,
        })
    # the wide route of kernels 1 and 2 (needles past the register
    # templates; wide_regs): the long needle's launch of the long query's
    # batch and its find (the whole batch's call beside it), and 4c's long
    # query
    res = wide
    kernels.append({
        "name": "affine_dp[wide]", "route": "cuda", "launch_route": res["launch_route"],
        "source": "vectorian_tpu_torch/csrc/affine_dp.cu",
        "replaces": "vectorian_tpu/ops/pallas_dp.py:369", "launches": res["launches"],
        "max_abs_err": max(worst_wide["affine_dp[wide]"], res["max_abs_err"]),
        "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"], "library_ms": None, "ms_find": res["ms_find"],
        "plain_ms_find": res["plain_ms_find"], "bound_ms_find": res["bound_ms_find"],
        "old_route_ms": res["old_route_ms"], "old_route_ms_find": res["old_route_ms_find"],
        "batch_ms": res["batch_ms"], "batch_plain_ms": res["batch_plain_ms"],
        "batch_plain_slices_a_bucket": res["batch_plain_slices_a_bucket"],
        "batch_bound_ms": res["batch_bound_ms"],
        "shapes_n_L_Tpad_Q": res["shapes_n_L_Tpad_Q"],
        "shapes_n_L_Tpad_Q_find": res["shapes_n_L_Tpad_Q_find"], "card": card,
    })
    # the tag-weighted block (K1, K2): kernels 1 and 3 at 4e's tagged pass,
    # the row-gather entries at 4c's tagged extras rounds
    for name, source, replaces in (
        ("affine_dp[tagged]", "affine_dp.cu", "vectorian_tpu/ops/pallas_dp.py:369"),
        ("wsb_dp[tagged]", "wsb_dp.cu", "vectorian_tpu/ops/pallas_dp.py:155"),
    ):
        res = options[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"vectorian_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": res["launches"],
            "max_abs_err": max(worst_tagged[name], res["max_abs_err"]),
            "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None,
            **{k: res[k] for k in ("untagged_ms", "host_ms", "old_ms", "old_untagged_ms",
                                   "ms_find", "untagged_ms_find", "host_ms_find",
                                   "old_ms_find", "old_untagged_ms_find") if k in res},
            "plain_ms_find": res["plain_ms_find"], "bound_ms_find": res["bound_ms_find"],
            "shapes_n_L_Tpad_Q": res["shapes_n_L_Tpad_Q"],
            "shapes_n_L_Tpad_Q_find": res["shapes_n_L_Tpad_Q_find"], "card": card,
        })
    for name, source, replaces in (
        ("affine_dp_flat[tagged]", "affine_dp.cu", "vectorian_tpu/ops/pallas_dp.py:44"),
        ("wsb_dp_flat[tagged]", "wsb_dp.cu", "vectorian_tpu/ops/pallas_dp.py:155"),
    ):
        res = rescore[name]
        err, times, plain_ms, bound, by = time_tagged_row_calls(name, res)
        kernels.append({
            "name": name, "route": "cuda",
            "entry": name.split("_flat")[0] + "_scores_rows",
            "source": f"vectorian_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": res["launches"], "max_abs_err": max(err, worst_tagged[name]),
            **times, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "rounds": res["rounds"],
            "launches_per_round": res["per_round"],
            "problems_per_call": [int(a[1].shape[0]) for _, a, _ in res["calls"]],
            "card": card,
        })
    # the dense-block entries (K3): 4f's contextual pass, find_batch (Q=32)
    # and find (Q=1); and 4h's tree pass (the "tree_" keys)
    for name, source, replaces in (
        ("affine_dp[dense]", "affine_dp.cu", "vectorian_tpu/ops/pallas_dp.py:369"),
        ("wsb_dp[dense]", "wsb_dp.cu", "vectorian_tpu/ops/pallas_dp.py:155"),
    ):
        res = dense[name]
        qb = max(q for q in res if q != "launches")
        (db, ms, plain_ms, bound, by, shape, x), (df, ms_f, plain_f, bound_f, _, shape_f,
                                                   xf) = res[qb], res[1]
        tr = tree[name]
        (dt, ms_t, plain_t, bound_t, by_t, shape_t, xt), xtf = tr[qb], tr[1][6]
        kernels.append({
            "name": name, "route": "cuda", "source": f"vectorian_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": res["launches"],
            "max_abs_err": max(worst_dense[name]["worst"], db, df, dt, tr[1][0]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "launch_route": x["route"], "old_ms": x["old_ms"],
            "host_ms": x["host_ms"], "launch_floor_ms": x["launch_floor_ms"],
            "ms_find": ms_f, "plain_ms_find": plain_f,
            "bound_ms_find": bound_f, "launch_route_find": xf["route"],
            "old_ms_find": xf["old_ms"], "host_ms_find": xf["host_ms"],
            "shapes_c_L_Tpad_Q": shape, "shapes_c_L_Tpad_Q_find": shape_f,
            "tree_launches": tr["launches"], "tree_ms": ms_t, "tree_old_ms": xt["old_ms"],
            "tree_plain_ms": plain_t, "tree_bound_ms": bound_t, "tree_bound_by": by_t,
            "tree_ms_find": tr[1][1], "tree_old_ms_find": xtf["old_ms"],
            "tree_shapes_c_L_Tpad_Q": shape_t, "card": card,
        })
    name = "affine_dp_flat[wide]"
    res = rescore[name]
    err, ms, plain_ms, bound, by, after, *_ = time_row_calls(name, res)
    kernels.append({
        "name": name, "route": "cuda",
        "launch_route": ",".join(r for r in res["routes"] if r.startswith("rows_wide")),
        "entry": "affine_dp_scores_rows", "source": "vectorian_tpu_torch/csrc/affine_dp.cu",
        "replaces": "vectorian_tpu/ops/pallas_dp.py:44", "launches": res["launches"],
        "max_abs_err": max(err, worst_wide[name]), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None, "rounds": res["rounds"],
        "launches_per_round": res["per_round"], "round_ms": after,
        "problems_per_call": [int(a[1].shape[0]) for _, a, _ in res["calls"]],
        "card": card,
    })
    # 4l: each kernel's launches on the paged paths (counts from 0 before
    # each path; every first launch held against its plain version there)
    for k in kernels:
        k["paged_launches"] = sum(d.get(k["name"], 0)
                                  for d in (paged_static, paged_ties, paged_ctx))
    # 4m: each kernel's launches on the mesh paths (counts from 0 before each
    # mesh call) and, where 4m held it on a shard's inputs, its equality
    for k in kernels:
        k["mesh_launches"] = sum(d["launches"].get(k["name"], 0) for d in (mesh, mesh_dense))
        err = {**mesh["err"], **mesh_dense["err"]}.get(k["name"])
        if err is not None:
            k["mesh_max_abs_err"] = err
            k["mesh_equal"] = True
        if k["name"] in mesh["shard_ms"]:
            k["mesh_shard_launches"] = mesh["shard_ms"][k["name"]]
    return kernels


def long_route_line(long, long_path, card):
    """The kernels line's entry of kernel 3's long route: phase 3's long
    shapes (``phase_kernels_long``) and 4r (``phase_long_path``)."""
    def total(case, key):
        return sum(b[key] for b in long_path["buckets"]
                   if b["case"] == case and b["route"] == "long")

    per_bucket = [{k: b.get(k) for k in ("case", "L", "n", "Q", "table", "ms", "old_route",
                                         "old_ms", "pass_ms", "plain_ms", "bound_ms")}
                  for b in long_path["buckets"] if b["route"] == "long"]
    biggest = max((b for b in long_path["buckets"] if b["case"] == "Q32" and b["route"] == "long"),
                  key=lambda b: b["bound_ms"])
    return {
        "name": "wsb_dp[long]", "route": "cuda", "launch_route": "long",
        "entry": "wsb_dp_scores (gather; rows and dense entries in phase 3)",
        "source": "vectorian_tpu_torch/csrc/wsb_dp.cu",
        "replaces": "vectorian_tpu/ops/pallas_dp.py:155",
        "launches": long_path["launches"],
        "max_abs_err": max(long["worst"], long_path["max_abs_err"]),
        "ms": total("Q32", "ms"), "plain_ms": total("Q32", "plain_ms"),
        "bound_ms": total("Q32", "bound_ms"), "bound_by": biggest["bound_by"],
        "library_ms": None, "old_ms": total("Q32", "old_ms"),
        "ms_int8": total("Q32_int8", "ms"), "old_ms_int8": total("Q32_int8", "old_ms"),
        "bound_ms_int8": total("Q32_int8", "bound_ms"),
        "ms_find": total("Q1", "ms"), "old_ms_find": total("Q1", "old_ms"),
        "bound_ms_find": total("Q1", "bound_ms"), "plain_ms_find": total("Q1", "plain_ms"),
        "buckets": per_bucket, "launches_by_route": long_path["launches_by_route"],
        "profiler_ms_launches": long_path["profiler"],
        "phase3_ratio_old": [[t["L"], t["Tpad"], t["Q"], t["ratio_old"]]
                             for t in long["turns"]],
        "card": card,
    }


def wide_route_line(phase3, path, prose, card):
    """The kernels line's entry of kernel 3's wide route: phase 3's wide
    shapes (``phase_kernels_wide_general``), the general long query
    (``phase_long_query_general``: ms / bound the long needle's find
    launch on the whole packing, plain ms on its WIDE_CUT slices a bucket)
    and 4r's prose-length batch (``phase_prose_batch``)."""
    keys = ("ms", "bound_ms", "ms_cut", "old_ms_cut", "bound_ms_cut", "plain_ms",
            "short_ms", "short_bound_ms", "pass_ms", "pass_bound_ms", "pass_ms_cut",
            "old_pass_ms_cut", "turns_cut", "pass_turns_cut", "shapes_n_L_Tpad_Q")
    return {
        "name": "wsb_dp[wide]", "route": "cuda", "launch_route": "wide",
        "entry": "wsb_dp_scores (gather; rows and dense entries in phase 3)",
        "source": "vectorian_tpu_torch/csrc/wsb_dp.cu",
        "replaces": "vectorian_tpu/ops/pallas_dp.py:155",
        "launches": path["launches"] + prose["launches"],
        "launches_long_query": path["launches"], "launches_prose_batch": prose["launches"],
        "max_abs_err": max(phase3["worst"], path["max_abs_err"]),
        "ms": path["ms_find"], "plain_ms": path["plain_ms_find"],
        "plain_slices_a_bucket": WIDE_CUT, "bound_ms": path["bound_ms_find"],
        "bound_by": path["bound_by"], "library_ms": None,
        "old_ms_cut": path["old_ms_cut_find"], "ms_cut": path["ms_cut_find"],
        "bound_ms_cut": path["bound_ms_cut_find"],
        "batch": {k: path.get(k) for k in keys},
        "batch_int8": {k: path.get(k + "[int8]") for k in keys},
        "find_p50_ms": path["find_p50_ms"], "find_batch_ms": path["find_batch_ms"],
        "prose_batch_ms": prose["find_batch_ms"],
        "prose_route_launches": prose["route_launches"],
        "phase3_ratio_old": [[t["L"], t["Tpad"], t["Q"], t["ratio_old"]]
                             for t in phase3["turns"]],
        "phase3_old_body_shapes": phase3["old_body_shapes"],
        "card": card,
    }


def long_check(card):
    """``--long-check``: phase 2 (build, ptxas gate), phase 3's long shapes
    with every gap model on every table type (LONG_ALL_MODELS) and the
    shared / scratch crossover (``phase_kernels_long``) and 4r on
    the length-mixed corpus (phase 4's vocabulary, its vectors drawn from
    the seed here), in a packed-corpus cache of its own; then the long
    route's kernels line."""
    global LONG_ALL_MODELS
    import numpy as np

    import vectorian_tpu_torch  # noqa: F401  (sets exact-f32 matmul flags)

    LONG_ALL_MODELS = True
    cache = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    os.environ["VECTORIAN_CACHE_HOME"] = cache
    try:
        phase_build()
        long = phase_kernels_long()
        log("long shapes match their plain versions")
        words = zipf_words()
        vectors = np.random.default_rng(SEED).normal(size=(len(words), 300)).astype(np.float32)
        long_path = phase_long_path(words, vectors, card)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    emit({"kernels": [long_route_line(long, long_path, card)]})
    log("long check done")


def quant_check(card, sass_dir=None):
    """``--quant-check``: phase 2 (build and ptxas gate; with ``--old-tree``
    the parent's kernels too), the quantized register templates' ptxas
    report and SASS instruction mix beside their f32 selves in each tree
    (``quant_register_templates``; the SASS into ``sass_dir`` where
    given), phase 3b (every shape, locality and gap model bit for bit,
    then ``quant_turns``) and phases 4 / 4b on the 1M-slice session
    (find_batch at int8, bf16 and f32 byte-identical to find, each
    quantized kernel at the path's shapes against its plain version and
    its f32 self), in a packed-corpus cache of its own."""
    import numpy as np

    import vectorian_tpu_torch  # noqa: F401  (sets exact-f32 matmul flags)
    from vectorian_tpu_torch.alignment import ExponentialGapCost
    from vectorian_tpu_torch.ops import dp_kernels

    cache = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    os.environ["VECTORIAN_CACHE_HOME"] = cache
    try:
        phase_build(old_reports=OLD is not None)
        for mod, tree in ((dp_kernels, "new"), (OLD, "old")):
            if mod is not None:
                quant_register_templates(mod, tree, sass_dir)
        emit({"phase": "quant_check_kernels", "max_abs_diff": phase_kernels_quant()})
        quant_turns()
        log("3b done")
        rng = np.random.default_rng(SEED)
        words, texts, query = zipf_corpus(SENTENCES, rng)
        vectors = rng.normal(size=(len(words), 300)).astype(np.float32)
        session = build_session(texts, words, vectors, DEVICE)
        queries = [query() for _ in range(32)]
        finds = [query() for _ in range(21)]
        phase_main_path(session, None, "main_path", queries, finds, card, SENTENCES)
        phase_main_path(session, ExponentialGapCost(3.0), "general_path", queries, finds,
                        card, SENTENCES)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    log("quant check done")


def wide_check(card):
    """``--wide-check``: phase 2 (build, ptxas gate), phase 3's wide cases
    and the long-query phase on phase 4's 1M-slice session, in a
    packed-corpus cache of its own."""
    import numpy as np

    import vectorian_tpu_torch  # noqa: F401  (sets exact-f32 matmul flags)

    cache = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    os.environ["VECTORIAN_CACHE_HOME"] = cache
    try:
        phase_build()
        phase_kernels_wide()
        rng = np.random.default_rng(SEED)
        words, texts, query = zipf_corpus(SENTENCES, rng)
        vectors = rng.normal(size=(len(words), 300)).astype(np.float32)
        session = build_session(texts, words, vectors, DEVICE)
        queries = [query() for _ in range(32)]
        [query() for _ in range(21)]  # the full run's finds: the same long query after them
        phase_long_query(session, query(160), queries, card)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    log("wide check done")


def wide_general_check(card):
    """``--wide-general-check``: phase 2 (build, ptxas gate), phase 3's wide
    shapes with every gap model on every table type and the rows and dense
    entries at every width (WIDE_ALL_MODELS), the old body's shapes
    (``old_body_shapes``), the general long query on phase 4's 1M-slice
    session (``phase_long_query_general``) and 4r's prose-length batch on
    4r's corpus (``phase_prose_batch``), in a packed-corpus cache of its
    own; then the wide route's kernels line."""
    global WIDE_ALL_MODELS
    import numpy as np

    import vectorian_tpu_torch  # noqa: F401  (sets exact-f32 matmul flags)
    from vectorian_tpu_torch.alignment import ExponentialGapCost

    WIDE_ALL_MODELS = True
    cache = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    os.environ["VECTORIAN_CACHE_HOME"] = cache
    try:
        phase_build()
        phase3 = phase_kernels_wide_general()
        old_body_shapes(np.random.default_rng(SEED + 11))
        log("wide shapes match their plain versions")
        rng = np.random.default_rng(SEED)
        words, texts, query = zipf_corpus(SENTENCES, rng)
        vectors = rng.normal(size=(len(words), 300)).astype(np.float32)
        session = build_session(texts, words, vectors, DEVICE)
        queries = [query() for _ in range(32)]
        [query() for _ in range(21)]  # the full run's finds: the same long query after them
        path = phase_long_query_general(session, query(160), queries, card)
        del session
        log("general long query done")
        texts, _, _ = lognormal_corpus(words, LONG_SENTENCES, np.random.default_rng(SEED + 12))
        session = build_session(texts, words, vectors, DEVICE)
        prose = phase_prose_batch(make_index(session, ExponentialGapCost(3.0)), words, card)
        del session
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    emit({"kernels": [wide_route_line(phase3, path, prose, card)]})
    log("wide general check done")


def batch_check(card):
    """``--batch-check``: phases 4k and 4l alone (their sessions built as
    the full run builds them), in a packed-corpus cache of their own."""
    import numpy as np

    import vectorian_tpu_torch  # noqa: F401  (sets exact-f32 matmul flags)

    cache = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    os.environ["VECTORIAN_CACHE_HOME"] = cache
    try:
        phase_build()
        rng = np.random.default_rng(SEED)
        words, texts, query = zipf_corpus(SENTENCES, rng)
        vectors = rng.normal(size=(len(words), 300)).astype(np.float32)
        session = build_session(texts, words, vectors, DEVICE)
        queries = [query() for _ in range(32)]
        finds = [query() for _ in range(21)]
        cut = {dev: build_session(corpus_cut(texts), words, vectors, dev)
               for dev in (DEVICE, "cpu")}
        tb = phase_transport_batch(session, queries, cut, card)
        phase_mesh_transport(session, queries, tb)
        phase_paged_static(session, queries, finds, card)
        del session, cut
        with tempfile.TemporaryDirectory(prefix="chip_smoke_fasttext_") as tmp:
            ft, _ = fasttext_model(texts, np.random.default_rng(SEED + 7), tmp)
        qft, _ = compress_fasttext(ft)
        del ft
        _, _, session, queries, finds, _ = ctx_corpus(qft)
        ctx = {"session": session, "queries": queries, "finds": finds}
        phase_transport_tree(ctx, card)
        phase_paged_contextual(ctx, card)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    log("batch check done")


def notebook_check(card):
    """``--notebook-check``: phase 2 and 4n alone, on the 3,000-sentence
    cut of phase 4's corpus (its renders, LabSession and InteractiveQuery,
    and a stored corpus of the cut's sentences), in a packed-corpus cache
    of its own."""
    import numpy as np

    import vectorian_tpu_torch  # noqa: F401  (sets exact-f32 matmul flags)

    cache = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    os.environ["VECTORIAN_CACHE_HOME"] = cache
    try:
        phase_build()
        rng = np.random.default_rng(SEED)
        words, texts, query = zipf_corpus(SENTENCES, rng)
        vectors = rng.normal(size=(len(words), 300)).astype(np.float32)
        queries = [query() for _ in range(32)]
        finds = [query() for _ in range(21)]
        n_cut = 3_000
        t = time.perf_counter()
        session = build_session(corpus_cut(texts, n_cut), words, vectors, DEVICE)
        make_index(session).packed
        t_build = time.perf_counter() - t
        phase_notebook_render(session, queries, finds, card)
        phase_lab_session(texts, words, vectors, session, finds, card)
        phase_interactive(session, finds, card)
        phase_corpus(texts, words, vectors, (n_cut, t_build), queries, finds, card, n_cut)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    log("notebook check done")


def mesh_check(card):
    """``--mesh-check``: phase 4m alone, on the sessions and 4k's batches
    the full run builds before it (4k runs too), in a packed-corpus cache
    of its own."""
    import numpy as np

    import vectorian_tpu_torch  # noqa: F401  (sets exact-f32 matmul flags)

    cache = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    os.environ["VECTORIAN_CACHE_HOME"] = cache
    try:
        phase_build()
        rng = np.random.default_rng(SEED)
        words, texts, query = zipf_corpus(SENTENCES, rng)
        vectors = rng.normal(size=(len(words), 300)).astype(np.float32)
        session = build_session(texts, words, vectors, DEVICE)
        queries = [query() for _ in range(32)]
        finds = [query() for _ in range(21)]
        cut = {dev: build_session(corpus_cut(texts), words, vectors, dev)
               for dev in (DEVICE, "cpu")}
        tb = phase_transport_batch(session, queries, cut, card)
        mesh = phase_mesh_static(session, queries, finds, card)
        phase_mesh_transport(session, queries, tb, turns=1)
        del session, cut
        with tempfile.TemporaryDirectory(prefix="chip_smoke_fasttext_") as tmp:
            ft, _ = fasttext_model(texts, np.random.default_rng(SEED + 7), tmp)
        qft, _ = compress_fasttext(ft)
        del ft
        _, _, session, queries, finds, _ = ctx_corpus(qft)
        mesh_dense = phase_mesh_dense({"session": session, "queries": queries}, card)
        emit({"phase": "mesh_kernels", "launches": [mesh["launches"], mesh_dense["launches"]],
              "max_abs_err": {**mesh["err"], **mesh_dense["err"]},
              "shard_launches": mesh["shard_ms"]})
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    log("mesh check done")


if __name__ == "__main__":
    old_tree = None
    if "--transport-reps" in sys.argv[1:]:
        i = sys.argv.index("--transport-reps")
        TRANSPORT_REPS = int(sys.argv[i + 1])
        del sys.argv[i : i + 2]
    if "--old-tree" in sys.argv[1:]:
        # the parent's tree, for the tagged kernels' old-against-new turns
        i = sys.argv.index("--old-tree")
        old_tree = sys.argv[i + 1]
        del sys.argv[i : i + 2]
    if sys.argv[1:2] == ["--dense-check"]:
        # phases 2, 3d and 4f alone: the quick check after a dense-entry edit
        if not (ROOT / "vectorian_tpu_torch" / "csrc" / "affine_dp.cu").exists():
            raise SystemExit("chip_smoke: run from a checkout of the repository")
        sys.path.insert(0, str(ROOT))
        card = phase_device()
        import vectorian_tpu_torch  # noqa: F401  (sets exact-f32 matmul flags)

        phase_build()
        phase_kernels_dense()
        phase_contextual(card)
    elif sys.argv[1:2] == ["--quant-check"]:
        # the quantized tables' kernels alone: the build and ptxas gate,
        # their templates' SASS, phase 3b and phases 4 / 4b
        if not (ROOT / "vectorian_tpu_torch" / "csrc" / "affine_dp.cu").exists():
            raise SystemExit("chip_smoke: run from a checkout of the repository")
        sys.path.insert(0, str(ROOT))
        card = phase_device()
        if old_tree is not None:
            OLD = load_old_tree(old_tree)
        quant_check(card, *sys.argv[2:3])
    elif sys.argv[1:2] == ["--long-check"]:
        # the build and ptxas gate, phase 3's long shapes and 4r alone: the
        # quick check after an edit of kernel 3's long route
        if not (ROOT / "vectorian_tpu_torch" / "csrc" / "affine_dp.cu").exists():
            raise SystemExit("chip_smoke: run from a checkout of the repository")
        sys.path.insert(0, str(ROOT))
        long_check(phase_device())
    elif sys.argv[1:2] == ["--wide-check"]:
        # the build and ptxas gate, phase 3's wide cases and the long-query
        # phase alone: the quick check after a wide-route edit
        if not (ROOT / "vectorian_tpu_torch" / "csrc" / "affine_dp.cu").exists():
            raise SystemExit("chip_smoke: run from a checkout of the repository")
        sys.path.insert(0, str(ROOT))
        wide_check(phase_device())
    elif sys.argv[1:2] == ["--wide-general-check"]:
        # the build and ptxas gate, phase 3's wide general-gap shapes, the
        # general long query and 4r's prose-length batch alone: the quick
        # check after an edit of kernel 3's wide route or its split
        if not (ROOT / "vectorian_tpu_torch" / "csrc" / "affine_dp.cu").exists():
            raise SystemExit("chip_smoke: run from a checkout of the repository")
        sys.path.insert(0, str(ROOT))
        wide_general_check(phase_device())
    elif sys.argv[1:2] == ["--batch-check"]:
        # 4k's batches (static and 4h's tree) and 4l over one bucket and
        # over SPLIT_BUCKETS, alone: the quick
        # check after a paging or transport-batch edit
        if not (ROOT / "vectorian_tpu_torch" / "csrc" / "affine_dp.cu").exists():
            raise SystemExit("chip_smoke: run from a checkout of the repository")
        sys.path.insert(0, str(ROOT))
        batch_check(phase_device())
    elif sys.argv[1:2] == ["--notebook-check"]:
        # phase 4n alone on a 3,000-sentence cut: the quick check after an
        # edit of the storage or notebook layer
        if not (ROOT / "vectorian_tpu_torch" / "csrc" / "affine_dp.cu").exists():
            raise SystemExit("chip_smoke: run from a checkout of the repository")
        sys.path.insert(0, str(ROOT))
        notebook_check(phase_device())
    elif sys.argv[1:2] == ["--mesh-check"]:
        # phase 4m (and the 4k batches it is held against) alone: the quick
        # check after a mesh edit
        if not (ROOT / "vectorian_tpu_torch" / "csrc" / "affine_dp.cu").exists():
            raise SystemExit("chip_smoke: run from a checkout of the repository")
        sys.path.insert(0, str(ROOT))
        mesh_check(phase_device())
    elif sys.argv[1:2] in (["--build-ab"], ["--tag-check"]):
        if not (ROOT / "vectorian_tpu_torch" / "csrc" / "affine_dp.cu").exists():
            raise SystemExit("chip_smoke: run from a checkout of the repository")
        sys.path.insert(0, str(ROOT))
        phase_device()
        if sys.argv[1] == "--build-ab":
            phase_build_ab()
        else:
            import vectorian_tpu_torch  # noqa: F401  (sets exact-f32 matmul flags)

            if old_tree is not None:
                OLD = load_old_tree(old_tree)
            phase_tag_check(*sys.argv[2:3])
    else:
        main(old_tree)
