#!/usr/bin/env python3
"""Smoke test of vectorian_tpu_torch on one NVIDIA card (an H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure:

1. Device: a CUDA card must be present; prints its name and power limit.
2. Build: compiles every kernel of the port from the checkout's sources
   (csrc/*.cu, one nvcc per source, all started together) and the native
   host library (native/, used by the traceback).
3. Kernels against their plain torch versions on the card, at main-path
   shapes (random tables and tokens from a seeded generator): the affine
   DP kernel must match bit for bit (max |diff| == 0).
4. Main path at real size: a 1,000,000-sentence Zipf corpus (9 tokens a
   sentence over 5,000 words, a 5,000 x 300 KeyedVectors), Session(device=
   "cuda") -> partition("sentence") -> index; find_batch of 32 queries and
   21 find() calls.  The kernel launch counts are set to 0 right before and
   read right after; find and find_batch must be byte-identical.  Then the
   port on the card is held against the port on the CPU on a small corpus.

Prints one JSON line per phase, the card's name and power limit, the
kernels' line ({"kernels": [...]}) and, last, {"ok": true, "device": ...}.
A torch.profiler trace of one find_batch and one find reports the device
busy time, idle share and top kernels.
"""

import concurrent.futures
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# f32 peak outside the tensor cores and HBM rate of an H100 SXM (NVIDIA
# data sheet, dense, at the 700 W power limit)
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
SEED = 0
DEVICE = "cuda"
SENTENCES = 1_000_000  # the bench.py e2e corpus size


def log(msg):
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def phase_build():
    from vectorian_tpu_torch import native
    from vectorian_tpu_torch.ops import dp_kernels

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        kernel = pool.submit(dp_kernels.build, True)  # prints the ptxas report
        host = pool.submit(native.available)
        lib = kernel.result()
        native_ok = host.result()
    emit({"phase": "build", "library": str(lib.relative_to(ROOT)),
          "native_traceback": bool(native_ok),
          "seconds": time.perf_counter() - t0})


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


def dp_bound_ms(tokens, len_s, len_t, table):
    """Least time for the affine DP on these inputs: bytes (each input read
    once, the [n, Q] output written once) over the HBM rate, against the
    f32 operations the data needs — rows up to each slice's length, columns
    up to each needle's length, 8 + 2 * ceil(log2(columns)) per cell —
    over the f32 peak.  Returns (ms, "bytes" | "operations")."""
    n, L = tokens.shape
    Q = table.shape[2]
    nbytes = (
        tokens.numel() * 4 + len_s.numel() * 4 + len_t.numel() * 4
        + table.numel() * 4 + n * Q * 4
    )
    rows = int(len_s.clamp(1, L).sum())
    per_row = sum(
        (lt + 1) * (8 + 2 * math.ceil(math.log2(lt + 1))) for lt in len_t.tolist()
    )
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = rows * per_row / PEAK_F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels():
    """affine_dp against its plain version at main-path shapes."""
    import numpy as np
    import torch

    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.alignment import AffineGapParams

    rng = np.random.default_rng(SEED)
    V, n = 5_000, 65_536
    gapsets = [(0.0, 0.0, 0.0, 0.0), (0.37, 0.113, 0.29, 0.071)]
    worst = 0.0
    for L in (16, 32):
        for Tpad in (8, 16):
            for Q in (1, 32, 512):
                dev = DEVICE
                table = torch.as_tensor(
                    rng.uniform(-0.4, 1.0, size=(V, Tpad, Q)).astype(np.float32), device=dev)
                tokens = torch.as_tensor(rng.integers(0, V, size=(n, L)).astype(np.int32), device=dev)
                ln = rng.integers(0, L + 1, size=n).astype(np.int32)
                ln[:2] = (0, L)
                len_s = torch.as_tensor(ln, device=dev)
                lt = rng.integers(1, Tpad + 1, size=Q).astype(np.int32)
                lt[0] = Tpad
                len_t = torch.as_tensor(lt, device=dev)
                for loc in ("local", "global", "semiglobal"):
                    for gs in gapsets:
                        gaps = AffineGapParams.of(*gs)
                        got = dp_kernels.affine_dp_scores(table, tokens, len_s, len_t, gaps, loc)
                        want = dp_kernels.affine_dp_scores_reference(
                            table, tokens, len_s, len_t, gaps, loc)
                        torch.cuda.synchronize()
                        if not bool(torch.isfinite(got).all()):
                            raise AssertionError(f"non-finite scores {L} {Tpad} {Q} {loc}")
                        diff = float((got - want).abs().max())
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"affine_dp != plain at L={L} Tpad={Tpad} Q={Q} "
                                f"{loc} gaps={gs}: max |diff| {diff}")
                        worst = max(worst, diff)
                gaps = AffineGapParams.of(*gapsets[1])
                ms = cuda_ms(lambda: dp_kernels.affine_dp_scores(
                    table, tokens, len_s, len_t, gaps, "local"), 10)
                plain_ms = cuda_ms(lambda: dp_kernels.affine_dp_scores_reference(
                    table, tokens, len_s, len_t, gaps, "local"), 1)
                bound, by = dp_bound_ms(tokens, len_s, len_t, table)
                emit({"phase": "kernel", "name": "affine_dp", "n": n, "L": L,
                      "Tpad": Tpad, "Q": Q, "localities": 3, "gapsets": len(gapsets),
                      "max_abs_diff": 0.0, "kernel_ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": by})
    return worst


def zipf_corpus(n_sents, rng):
    """The bench.py e2e corpus: Zipf(1.2) sentences of 9 tokens over 5,000
    alphabetic words, 2,000 sentences per document."""
    import numpy as np

    V_words = 5_000

    def word(i):
        s, i = "", i + 1
        while i:
            s += chr(ord("a") + i % 26)
            i //= 26
        return "w" + s

    words = [word(i) for i in range(V_words)]
    sents_per_doc = min(2_000, n_sents)
    texts = []
    for _ in range(max(n_sents // sents_per_doc, 1)):
        ids = np.minimum(rng.zipf(1.2, size=(sents_per_doc, 9)), V_words - 1)
        texts.append(" ".join(" ".join(words[i] for i in row) + "." for row in ids))

    def query():
        return " ".join(words[int(i)] for i in np.minimum(rng.zipf(1.2, size=7), V_words - 1))

    return words, texts, query


def build_index(texts, words, vectors, device):
    import vectorian_tpu_torch as vt
    from vectorian_tpu_torch.metrics import EmbeddingTokenSim

    emb = vt.KeyedVectors("syn", words, vectors)
    docs = [vt.StringImporter()(t, title=f"d{i}") for i, t in enumerate(texts)]
    session = vt.Session(docs, embeddings=[emb], device=device)
    return session.partition("sentence").index(EmbeddingTokenSim(emb))


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
    (the profiler's own overhead inflates the wall time it sees)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    emit({"phase": "profile", "call": label, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
          "top_kernels_ms_count": [
              [e.key[:70], e.self_device_time_total / 1e3, e.count] for e in top]})


def phase_main_path(n_sents, card):
    import numpy as np
    import torch

    from vectorian_tpu_torch.ops import dp_kernels
    from vectorian_tpu_torch.ops.search import stack_query_tables

    rng = np.random.default_rng(SEED)
    words, texts, query = zipf_corpus(n_sents, rng)
    vectors = rng.normal(size=(len(words), 300)).astype(np.float32)
    t0 = time.perf_counter()
    index = build_index(texts, words, vectors, DEVICE)
    n_slices = index.packed.n_slices
    t_build = time.perf_counter() - t0
    log(f"host build {t_build:.1f} s, {n_slices} slices")
    Q, n, min_score = 32, 10, 0.2
    queries = [query() for _ in range(Q)]
    finds = [query() for _ in range(21)]

    # ---- the main path: launch counts from 0, read right after ----
    dp_kernels.reset_launches()
    batch = index.find_batch(queries, n=n, min_score=min_score, sim_precision="float32")
    launches_batch = dp_kernels.LAUNCHES["affine_dp"]
    if launches_batch == 0:
        raise AssertionError("find_batch launched no affine_dp kernel")
    lats = []
    for q in finds:
        t = time.perf_counter()
        r = index.find(q, n=n, min_score=min_score)
        lats.append(time.perf_counter() - t)
        check_results([r], n, min_score)
    launches_find = dp_kernels.LAUNCHES["affine_dp"] - launches_batch
    if launches_find == 0:
        raise AssertionError("find launched no affine_dp kernel")
    pass_times = []
    for _ in range(3):
        t = time.perf_counter()
        batch = index.find_batch(queries, n=n, min_score=min_score, sim_precision="float32")
        pass_times.append(time.perf_counter() - t)
    singles = [pairs(index.find(q, n=n, min_score=min_score)) for q in queries[:8]]
    launches = dp_kernels.LAUNCHES["affine_dp"]
    # ---- end of the main path ----

    check_results(batch, n, min_score)
    if not any(len(r) for r in batch):
        raise AssertionError("find_batch returned no matches at all")
    if singles != [pairs(r) for r in batch[:8]]:
        raise AssertionError("find and find_batch differ")
    dt_batch = float(np.median(pass_times))
    emit({
        "phase": "main_path", "card": card, "sentences": n_sents,
        "slices": n_slices, "host_build_s": t_build,
        "find_p50_ms": float(np.percentile(np.asarray(lats) * 1e3, 50)),
        "find_batch_Q": Q, "find_batch_s": dt_batch,
        "alignments_per_s": n_slices * Q / dt_batch,
        "launches_per_find": launches_find / len(finds),
        "launches_per_find_batch": launches_batch,
        "launches": launches,
        "find_equals_find_batch": True,
    })
    profile_calls("find_batch_Q32", lambda: index.find_batch(
        queries, n=n, min_score=min_score, sim_precision="float32"))
    profile_calls("find", lambda: index.find(finds[0], n=n, min_score=min_score))

    # kernel vs plain at the shapes the main path gave the kernel (the
    # Q=32 batch over every bucket); these launches are not counted
    engine = index._engine
    _, plans, len_ts, _ = index._prepare_static_batch(queries, n, min_score, {})
    table, _ = stack_query_tables(plans, len_ts)
    lt = torch.as_tensor(np.asarray(len_ts, np.int32), device=DEVICE)
    ms = plain_ms = bound = 0.0
    worst = 0.0
    by = "operations"
    for db in engine._device_buckets:
        args = (table, db["tokens"], db["lengths"], lt, index._gaps, "local")
        got = dp_kernels.affine_dp_scores(*args)
        want = dp_kernels.affine_dp_scores_reference(*args)
        if not torch.equal(got, want):
            raise AssertionError("affine_dp != plain at the main-path shapes")
        worst = max(worst, float((got - want).abs().max()))
        ms += cuda_ms(lambda: dp_kernels.affine_dp_scores(*args), 20)
        plain_ms += cuda_ms(lambda: dp_kernels.affine_dp_scores_reference(*args), 1)
        b, by = dp_bound_ms(db["tokens"], db["lengths"], lt, table)
        bound += b
    shapes = [[int(db["n"]), int(db["capacity"]), int(table.shape[1]), Q]
              for db in engine._device_buckets]
    return launches, worst, ms, plain_ms, bound, by, shapes


def phase_small_reference():
    """The port on the card against the port on the CPU, small corpus."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    words, texts, query = zipf_corpus(4_000, rng)
    vectors = rng.normal(size=(len(words), 300)).astype(np.float32)
    qs = [query() for _ in range(8)]
    on_card = build_index(texts, words, vectors, DEVICE)
    on_cpu = build_index(texts, words, vectors, "cpu")
    a = [pairs(r) for r in on_card.find_batch(qs, n=10, min_score=0.1)]
    b = [pairs(r) for r in on_cpu.find_batch(qs, n=10, min_score=0.1)]
    worst = 0.0
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            raise AssertionError("card and CPU return different match counts")
        for (ia, sa), (ib, sb) in zip(ra, rb):
            err = abs(sa - sb)
            worst = max(worst, err)
            # the [V, T] GEMM sums in another order on the card: 1e-6 relative
            if err > 1e-6 * max(1.0, abs(sb)) or (ia != ib and err > 1e-6):
                raise AssertionError(f"card {ra} != CPU {rb}")
    emit({"phase": "small_reference", "queries": len(qs),
          "max_abs_score_diff_vs_cpu": worst})


def main():
    if not (ROOT / "vectorian_tpu_torch" / "csrc" / "affine_dp.cu").exists():
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch

    card = phase_device()
    kind = torch.cuda.get_device_name(0)
    log(f"device {card}")
    import vectorian_tpu_torch  # noqa: F401  (sets exact-f32 matmul flags)

    phase_build()
    log("built")
    worst = phase_kernels()
    log("kernels match their plain versions")
    launches, worst_mp, ms, plain_ms, bound, by, shapes = phase_main_path(
        SENTENCES, card)
    log("main path done")
    phase_small_reference()
    emit({"kernels": [{
        "name": "affine_dp", "route": "cuda",
        "source": "vectorian_tpu_torch/csrc/affine_dp.cu",
        "replaces": "vectorian_tpu/ops/pallas_dp.py:369",
        "launches": launches, "max_abs_err": max(worst, worst_mp),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None, "shapes_n_L_Tpad_Q": shapes, "card": card,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
