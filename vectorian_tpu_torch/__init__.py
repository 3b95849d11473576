"""vectorian_tpu_torch — the PyTorch/CUDA port of the vectorian_tpu package.

An index-free sentence-search engine (the Vectorian, poke1024/vectorian):
interactive searches over word embeddings with sequence alignment.  This
package mirrors vectorian_tpu's module layout and public API, runs on an
NVIDIA H100 (``Session(device="cuda")``, the default) or the CPU
(``device="cpu"``), and scores every corpus pass with a hand-written CUDA
DP kernel (ops/dp_kernels.py: csrc/affine_dp.cu for affine gap models,
csrc/wsb_dp.cu for any other).

Served so far: static embeddings, token similarity metrics and modifier
trees, local/global/semiglobal alignment with affine or general
(Waterman-Smith-Beyer) gap models, ``find`` (f32 tables) and
``find_batch`` (int8 ranking tables by default, as in the JAX package, or
``sim_precision="bfloat16"`` / ``"float32"``; every precision returns the
same matches).  Everything else raises NotImplementedError naming its
ROADMAP.md port queue item.
"""

import sys as _sys

import torch as _torch

# exact f32 GEMMs: the JAX package uses precision=HIGHEST (TF32-class
# products are off by ~1e-3)
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from vectorian_tpu_torch.session import Partition, Result, Session  # noqa: E402
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
from vectorian_tpu_torch.embedding.static import (  # noqa: E402,F401
    KeyedVectors,
    OneHotEncoding,
    PretrainedGloVe,
    StackedEmbedding,
    Word2VecVectors,
)
from vectorian_tpu_torch import alignment, metrics, sim  # noqa: E402,F401

# alias matching the reference's dual naming (__init__.py:24-25)
similarity = metrics
_sys.modules[__name__ + ".similarity"] = metrics
