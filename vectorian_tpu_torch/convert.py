"""Carry a vectorian_tpu session's state into the port.

The system has no weights: its state is the frequency-ordered vocabulary,
the compiled [V, d] static embedding matrices, the packed corpus and, for a
contextual embedding, each document's per-token vectors and the fitted
arrays of its transforms (PCA).  The JAX package's state, exported as numpy
arrays, becomes the port's ``PackedCorpus`` and ``CompiledEmbedding``
objects on a torch device (``state_from_numpy``) and a port session's
contextual state (``contextual_from_numpy``), so both packages can be held
to the very same state.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from vectorian_tpu_torch.corpus.packing import PackedBucket, PackedCorpus, Partition
from vectorian_tpu_torch.embedding.static import StaticEmbeddingEncoder
from vectorian_tpu_torch.embedding.transform import LinearProjection
from vectorian_tpu_torch.ops.simmatrix import CompiledEmbedding


def state_from_numpy(
    arrays: dict, device="cuda"
) -> Tuple[PackedCorpus, Dict[str, CompiledEmbedding]]:
    """``arrays`` holds:

    - ``vocab``: the token strings in id (frequency) order, PAD first;
    - ``embeddings``: {name: [V, d] f32 unmodified vectors, row i = vocab
      token i};
    - ``buckets``: one dict per length bucket with ``capacity``,
      ``tokens``, ``pos``, ``tag``, ``lengths`` and ``slice_index``;
    - ``slice_doc``, ``slice_idx``, ``slice_start``, ``slice_len``;
    - ``partition``: (level, window_size, window_step) and ``n_docs``.

    Returns (packed corpus, {name: compiled embedding on ``device``}).  The
    compiled encoders know only the vocabulary's words: a query token
    outside the corpus vocabulary encodes to a zero vector."""
    vocab = list(arrays["vocab"])
    compiled = {}
    for name, matrix in arrays["embeddings"].items():
        matrix = np.asarray(matrix, np.float32)
        if matrix.shape[0] != len(vocab):
            raise ValueError(
                f"embedding {name!r}: {matrix.shape[0]} rows for a "
                f"{len(vocab)}-token vocabulary"
            )
        encoder = StaticEmbeddingEncoder(name, vocab, matrix)
        compiled[name] = CompiledEmbedding(name, encoder, vocab, device=device)
    buckets = [
        PackedBucket(
            capacity=int(b["capacity"]),
            token_ids=np.asarray(b["tokens"], np.int32),
            pos_ids=np.asarray(b["pos"], np.int8),
            tag_ids=np.asarray(b["tag"], np.int16),
            lengths=np.asarray(b["lengths"], np.int32),
            slice_index=np.asarray(b["slice_index"], np.int32),
        )
        for b in arrays["buckets"]
    ]
    packed = PackedCorpus(
        partition=Partition(*arrays["partition"]),
        buckets=buckets,
        slice_doc=np.asarray(arrays["slice_doc"], np.int32),
        slice_idx=np.asarray(arrays["slice_idx"], np.int32),
        slice_start=np.asarray(arrays["slice_start"], np.int32),
        slice_len=np.asarray(arrays["slice_len"], np.int32),
        n_docs=int(arrays["n_docs"]),
    )
    return packed, compiled


def contextual_from_numpy(session, name: str, vectors, transforms=()) -> None:
    """Give the port ``session`` (built with the contextual embedding
    ``name``) another session's contextual state: ``vectors`` one [m, d]
    array a prepared document (its kept tokens' vectors, after the
    transforms: ``PreparedDocument.contextual[name]``), ``transforms`` the
    fitted (mean, components) pairs of its PCA compressions in order (the
    needle's vectors replay them).  Device stores packed from the old
    vectors are dropped."""
    docs = session.documents
    if len(vectors) != len(docs):
        raise ValueError(f"{len(vectors)} vector arrays for {len(docs)} documents")
    for pd, v in zip(docs, vectors):
        v = np.asarray(v, np.float32)
        if len(v) != len(pd.orig_index):
            raise ValueError(
                f"document {pd.doc_index}: {len(v)} vectors for "
                f"{len(pd.orig_index)} tokens"
            )
        pd.contextual[name] = v
    session._ctx_fitted[name] = [LinearProjection(m, c) for m, c in transforms]
    session._ctx_dims[name] = next(
        (int(np.asarray(v).shape[1]) for v in vectors if len(v)), 0
    )
    for engine in session._engine_cache.values():
        engine._ctx_stores.pop(name, None)
