"""The contextual and mixed-tree batches over a mesh of CPU devices.

tests/test_torch_contextual.py's fixture (a static and a contextual
embedding over a few hundred sentences): ``find_batch(mesh=)`` of one
contextual embedding and of MixedTokenSimilarity / MaximumTokenSimilarity
trees, under affine and general gaps and the query options (a booster, a
document-side filter, ``submatch_weight``, ``bidirectional``, tag
weights), returns the port's single-device batch byte for byte at mesh
sizes 1, 3 and 8, and agrees with the JAX package's ``find_batch(mesh=)``
within 1e-6 (ids may differ only inside bands of tied scores).  The
contextual stores shard by row views of the engine's stores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorian_tpu_torch as vt
from vectorian_tpu.parallel import mesh as jax_mesh

from tests.test_torch_contextual import CTX_OPTIONS, QUERIES, _ctx_indexes, _options, _sessions
from tests.test_torch_slice import _assert_same_ranking, _pairs

torch.set_num_threads(2)

TAGS = {"tag_weights": {"NN": 1.0, "VB": 0.5, "DT": 0.2},
        "pos_mismatch_penalty": 0.3, "similarity_threshold": 0.05}


@pytest.fixture(scope="module")
def both():
    return _sessions()


@pytest.fixture(scope="module")
def jax_ms():
    assert len(jax.devices()) == 8, jax.devices()
    return jax_mesh.MeshSearch(jax_mesh.make_mesh())


def _batch(ix, **kw):
    return [_pairs(r) for r in ix.find_batch(QUERIES + [""], n=4, min_score=0.1, **kw)]


@pytest.mark.parametrize("size", [1, 3, 8])
@pytest.mark.parametrize("tree", [None, "mixed", "max"])
@pytest.mark.parametrize("general", [False, True])
def test_mesh_batch_is_the_single_device_batch(both, jax_ms, size, tree, general):
    sj, st = both
    ij, it = _ctx_indexes(sj, st, general=general, tree=tree)
    want = _batch(it)
    assert any(want) and want[-1] == []
    got = _batch(it, mesh=vt.make_mesh(["cpu"] * size))
    assert got == want
    if size == 8 and not general:
        for w, g in zip(_batch(ij, mesh=jax_ms), got):
            _assert_same_ranking(w, g, 0.1)


@pytest.mark.parametrize("option", sorted(CTX_OPTIONS) + ["tags"])
@pytest.mark.parametrize("tree", [None, "mixed"])
@pytest.mark.parametrize("general", [False, True])
def test_mesh_batch_options(both, option, tree, general):
    sj, st = both
    span = TAGS if option == "tags" else {}
    _, it = _ctx_indexes(sj, st, general=general, tree=tree, **span)
    kw = {} if option == "tags" else _options(option, "port")
    want = _batch(it, **kw)
    assert any(want)
    assert _batch(it, mesh=vt.make_mesh(["cpu"] * 3), **kw) == want


def test_find_mesh_of_a_contextual_plan_is_find(both):
    sj, st = both
    _, it = _ctx_indexes(sj, st, tree="max")
    mesh = vt.make_mesh(["cpu"] * 3)
    for q in QUERIES:
        assert _pairs(it.find(q, n=4, min_score=0.1, mesh=mesh)) == _pairs(
            it.find(q, n=4, min_score=0.1))


def test_contextual_stores_shard_by_views(both):
    """A shard on the engine's device is a row view of the engine's store:
    the mesh adds no copy of the contextual vectors there."""
    sj, st = both
    _, it = _ctx_indexes(sj, st)
    ms = vt.MeshSearch(vt.make_mesh(["cpu"] * 3))
    it.find_batch(QUERIES[:1], n=2, mesh=ms)
    stores = it._engine._ctx_stores["ctx"]
    for bi, sh in ms.ctx_shards(it._engine, "ctx").items():
        for i, part in enumerate(sh.parts):
            r0, r1 = sh.bounds(i)
            if r1 > r0:
                assert part.data_ptr() == stores[bi][r0].data_ptr()
                assert torch.equal(part, stores[bi][r0:r1])


def test_ctx_score_topk_multiquery_matches_jax(jax_ms):
    """MeshSearch.ctx_score_topk_multiquery (the one-leaf contextual tree)
    against the JAX package's on the same [N, L, d] store and stacked
    needle rows: the same candidates, scores within 1e-6, next_best."""
    from vectorian_tpu.ops.alignment import AffineGapParams as JaxGaps
    from vectorian_tpu.sim.vector import CosineSim as JaxCosine
    from vectorian_tpu_torch.ops.alignment import AffineGapParams
    from vectorian_tpu_torch.sim.vector import CosineSim

    rng = np.random.default_rng(21)
    N, L, d, T, Q, k = 61, 6, 8, 8, 3, 5
    store = rng.normal(size=(N, L, d)).astype(np.float32)
    lengths = rng.integers(0, L + 1, size=N).astype(np.int32)
    len_t = np.asarray([8, 5, 3], np.int32)
    qv = rng.normal(size=(T, Q, d)).astype(np.float32)
    qv[np.arange(T)[:, None] >= len_t[None, :]] = 0.0
    mags = np.linalg.norm(qv, axis=-1)
    normed = (qv / np.maximum(mags, 1e-9)[..., None]).reshape(T * Q, d)
    unmod, mags = qv.reshape(T * Q, d), mags.reshape(T * Q).astype(np.float32)
    nt = len_t.astype(np.float32)
    g = (0.2, 0.1, 0.2, 0.1)
    pad = (-N) % 8
    want = [np.asarray(x) for x in jax_ms.ctx_score_topk_multiquery(
        jax.device_put(np.pad(store, ((0, pad), (0, 0), (0, 0))), jax_ms._sharded),
        jax.device_put(np.pad(lengths, (0, pad)), jax_ms._sharded),
        jax_ms.put_replicated(normed), jax_ms.put_replicated(unmod),
        jax_ms.put_replicated(mags), jnp.asarray(len_t), JaxGaps.of(*g),
        jnp.asarray(nt), JaxCosine(), k=k, with_next=True)]
    ms = vt.MeshSearch(vt.make_mesh(["cpu"] * 8))
    got = ms.ctx_score_topk_multiquery(
        ms.shard_rows(store), ms.shard_rows(lengths), normed, unmod, mags, len_t,
        AffineGapParams.of(*g), nt, CosineSim(), k=k, with_next=True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-7)
    for q in range(Q):
        f = np.isfinite(want[0][q])
        assert set(got[1][q][f].tolist()) == set(want[1][q][f].tolist())
