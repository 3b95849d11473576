"""vectorian_tpu_torch — the PyTorch/CUDA port of the vectorian_tpu package.

An index-free sentence-search engine (the Vectorian, poke1024/vectorian):
interactive searches over word embeddings with sequence alignment.  This
package mirrors vectorian_tpu's module layout and public API, runs on an
NVIDIA H100 (``Session(device="cuda")``, the default) or the CPU
(``device="cpu"``), and scores every corpus pass with a hand-written CUDA
DP kernel (ops/dp_kernels.py: csrc/affine_dp.cu for affine gap models,
csrc/wsb_dp.cu for any other).

Served so far: static embeddings (KeyedVectors, GloVe, word2vec, fastText
.bin / .ftz and its product-quantized forms), token similarity metrics and
modifier trees, local/global/semiglobal alignment with affine or general
(Waterman-Smith-Beyer) gap models and needles of any length, ``find`` (f32
tables) and ``find_batch`` (int8 ranking tables by default, as in the
reference package, or ``sim_precision="bfloat16"`` / ``"float32"``; every
precision returns the same matches; tag weights force f32), the query
options tag weights, ``pos_filter`` / ``tag_filter`` / ``token_filter``,
``booster`` (``Saliency``) and ``bidirectional``, ``BruteForceIndex.warmup``
and the on-disk packed-corpus cache, ``submatch_weight`` and ``debug``;
contextual embeddings (``LambdaContextualEmbedding``,
``TransformerContextualEmbedding``, their ``.pca(n)``) and mixed static +
contextual modifier trees through ``find`` and ``find_batch``, whose dense
similarity blocks the same DP kernels read; span embeddings
(``SentenceEmbedding``, ``TextSpanEmbedding``, ``SpacySpanEmbedding``)
through ``EmbeddedSpanSim``'s exact and approximate indexes; the transport
metrics (``WordMoversDistance``, relaxed or full, and
``WordRotatorsDistance``) through ``find`` and ``find_batch``; paged
serving (``Session(paged=True)``); multi-device serving (``make_mesh``,
``MeshSearch``: ``find_batch(mesh=)`` and ``find(mesh=)`` on every batch
path, with the single-device bytes); stored corpora (``Corpus``,
``TemporaryCorpus``: a ``Session`` over a reopened corpus restores its
stored normalization flavor), ``Result.format`` and the HTML renderers
(``render/``), ``LabSession``, the notebook query builder
(``interact.InteractiveQuery``) and the embedding registry ``Zoo``.  Every
public name of the reference package is served.
"""

import sys as _sys

import torch as _torch

# exact f32 GEMMs: the JAX package uses precision=HIGHEST (TF32-class
# products are off by ~1e-3)
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from vectorian_tpu_torch.session import LabSession, Partition, Result, Session  # noqa: E402,F401
from vectorian_tpu_torch.normalization import (  # noqa: E402
    LowercaseNormalization,
    Normalization,
    VanillaNormalization,
)
from vectorian_tpu_torch.corpus.document import Document, Span, Token  # noqa: E402
from vectorian_tpu_torch.importers import (  # noqa: E402
    Importer,
    MarkdownImporter,
    NovelImporter,
    PlayShakespeareImporter,
    StringImporter,
    TextImporter,
)
from vectorian_tpu_torch.utils.progress import set_verbose  # noqa: E402
from vectorian_tpu_torch.corpus.corpus import Corpus, TemporaryCorpus  # noqa: E402,F401
from vectorian_tpu_torch.embedding.static import (  # noqa: E402,F401
    KeyedVectors,
    OneHotEncoding,
    PretrainedGloVe,
    StackedEmbedding,
    Word2VecVectors,
)
from vectorian_tpu_torch.embedding.contextual import (  # noqa: E402,F401
    ContextualEmbedding,
    LambdaContextualEmbedding,
    TransformerContextualEmbedding,
)
from vectorian_tpu_torch.embedding.fasttext import (  # noqa: E402,F401
    CompressedFastTextVectors,
    PretrainedFastText,
)
from vectorian_tpu_torch.embedding.span import (  # noqa: E402,F401
    AggregatedTokenEmbedding,
    SentenceEmbedding,
    TextSpanEmbedding,
)
from vectorian_tpu_torch.embedding.pipeline import (  # noqa: E402,F401
    SpacySpanEmbedding,
    decompose_nlp,
    register_decomposer,
)
from vectorian_tpu_torch.embedding.zoo import Zoo  # noqa: E402,F401
from vectorian_tpu_torch import alignment, metrics, saliency, sim  # noqa: E402,F401
from vectorian_tpu_torch.saliency import KeywordSignal, Saliency  # noqa: E402,F401
from vectorian_tpu_torch.parallel.mesh import MeshSearch, make_mesh  # noqa: E402,F401

# alias matching the reference's dual naming (__init__.py:24-25)
similarity = metrics
_sys.modules[__name__ + ".similarity"] = metrics


def compile():
    """Build the native host library now (reference's dev compile() hook,
    __init__.py:5-23; normally built at first use into
    vectorian_tpu_torch/_build/).  True when it loads."""
    from vectorian_tpu_torch import native

    return native.available()


def backend_build_time():
    """Build time of the port's native library (reference
    backend_build_time(), core/cpp/module.cpp:20-34); None if it is not
    built."""
    import datetime

    from vectorian_tpu_torch import native

    try:
        so = native.library_path()
    except OSError:  # no native source in this installation
        return None
    if not so.exists():
        return None
    return datetime.datetime.fromtimestamp(so.stat().st_mtime)
