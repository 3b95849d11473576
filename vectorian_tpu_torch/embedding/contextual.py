"""Contextual (per-token-occurrence) embeddings.

Reference: vectorian/embedding/token/contextual.py — per-token vectors from
spaCy pipelines (`token.vector` impl :32, transformer-tensor alignment
averaging impl :50-87), stored per document, with optional PCA compression
(pca(n_dims):161-163 + transform.py).

Here encoders are pluggable; the built-in transformer encoder uses HF
``transformers`` directly (no spaCy): word-level vectors are mean-pooled
subword states aligned by character offsets — the same alignment-averaging
contract as the reference.  Vectors are computed at import time (or lazily
at session prepare) and packed per (embedding, partition) into [N, L, d]
bucket arrays (bf16 on the session's device) so the per-document GIL-held
python metric of the reference (metric/contextual.cpp:26-75) becomes one
batched metric GEMM per chunk of slices (ops/simmatrix.eval_plan_chunk and
the batch form in ops/search).  The transformer encoder runs on its own
``device`` argument, apart from the session's: ``"cuda"`` by default,
which needs a CUDA card and raises without one; ``device="cpu"`` runs it
on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from vectorian_tpu_torch.embedding.static import TokenEmbedding
from vectorian_tpu_torch.embedding.transform import PCACompression


class ContextualEmbedding(TokenEmbedding):
    """Base contextual embedding; subclasses implement encode_doc."""

    def __init__(self, name: str, transforms=()):
        self._name = name
        self._transforms = tuple(transforms)

    @property
    def name(self):
        return self._name

    @property
    def is_static(self):
        return False

    @property
    def transforms(self):
        return self._transforms

    def pca(self, n_dims: int) -> "ContextualEmbedding":
        """PCA-compressed variant (reference contextual.py:161-163); the
        projection is fitted on the corpus vectors at session compile and
        replayed on query vectors."""
        clone = self.__class__.__new__(self.__class__)
        clone.__dict__.update(self.__dict__)
        clone._transforms = self._transforms + (PCACompression(n_dims),)
        return clone

    def encode_doc(self, sdoc, text: str) -> np.ndarray:
        """[n_tokens, d] raw vectors for one parsed doc."""
        raise NotImplementedError()

    def to_token_sim(self, metric=None):
        from vectorian_tpu_torch.sim.token import EmbeddingTokenSim

        return EmbeddingTokenSim(self, metric)

    def create_encoder(self, normalization=None):
        return self


class LambdaContextualEmbedding(ContextualEmbedding):
    """User-supplied function (tokens, text) -> [n, d] (reference's custom
    spaCy-encoder escape hatch)."""

    def __init__(self, name: str, fn: Callable, dimension: int, transforms=()):
        super().__init__(name, transforms)
        self._fn = fn
        self._dimension = dimension

    @property
    def dimension(self):
        return self._dimension

    def encode_doc(self, sdoc, text: str) -> np.ndarray:
        j = sdoc.to_json() if hasattr(sdoc, "to_json") else sdoc
        tokens = [(t["start"], t["end"]) for t in j["tokens"]]
        out = np.asarray(self._fn(tokens, text), np.float32)
        assert out.shape == (len(tokens), self._dimension), out.shape
        return out


class TransformerContextualEmbedding(ContextualEmbedding):
    """HF-transformers word vectors: subword states mean-pooled per word by
    char-offset alignment (the reference's trf_data alignment averaging,
    contextual.py:58-87, without spaCy)."""

    def __init__(self, model_name: str, layer: int = -1, device: str = "cuda",
                 max_length: int = 512, transforms=()):
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TransformerContextualEmbedding(device='cuda') needs a CUDA "
                "device and none is available; pass device='cpu' to run on "
                "the CPU"
            )
        super().__init__(f"trf-{model_name.replace('/', '-')}", transforms)
        self._model_name = model_name
        self._layer = layer
        self._device = device
        self._max_length = max_length
        self._tok = None
        self._model = None

    def _ensure_model(self):
        if self._model is None:
            from transformers import AutoModel, AutoTokenizer

            self._tok = AutoTokenizer.from_pretrained(self._model_name)
            self._model = AutoModel.from_pretrained(self._model_name)
            self._model.to(self._device)
            self._model.eval()

    @property
    def dimension(self):
        self._ensure_model()
        return int(self._model.config.hidden_size)

    def encode_doc(self, sdoc, text: str) -> np.ndarray:
        self._ensure_model()
        j = sdoc.to_json() if hasattr(sdoc, "to_json") else sdoc
        words = [(t["start"], t["end"]) for t in j["tokens"]]
        enc = self._tok(
            text,
            return_offsets_mapping=True,
            return_tensors="pt",
            truncation=True,
            max_length=self._max_length,
        )
        offsets = enc.pop("offset_mapping")[0].numpy()
        enc = {k: v.to(self._device) for k, v in enc.items()}
        with torch.no_grad():
            out = self._model(**enc, output_hidden_states=True)
        states = (
            out.hidden_states[self._layer][0].cpu().numpy()
        )  # [n_pieces, d]

        d = states.shape[1]
        vecs = np.zeros((len(words), d), np.float32)
        for wi, (w0, w1) in enumerate(words):
            # pieces overlapping [w0, w1)
            sel = [
                pi
                for pi, (p0, p1) in enumerate(offsets)
                if p1 > p0 and p0 < w1 and p1 > w0
            ]
            if sel:
                vecs[wi] = states[sel].mean(axis=0)
        return vecs
