"""Facade re-exporting all similarity strategies (reference:
vectorian/metrics.py — aliased as both vectorian.metrics and
vectorian.similarity)."""

from vectorian_tpu_torch.sim.vector import (  # noqa: F401
    CosineSim,
    DirectionalDistance,
    EuclideanDistance,
    FuzzyJaccardSim,
    ImprovedSqrtCosineSim,
    LoggingSimilarity,
    ModifiedVectorSim,
    PNormDistance,
    VectorSim,
)
from vectorian_tpu_torch.sim.kernel import (  # noqa: F401
    Bias,
    DistanceToSimilarity,
    Kernel,
    Power,
    RadialBasis,
    Scale,
    Threshold,
    UnaryOperator,
)
from vectorian_tpu_torch.sim.token import EmbeddingTokenSim, TokenSim  # noqa: F401
from vectorian_tpu_torch.sim.modifier import (  # noqa: F401
    MaximumTokenSimilarity,
    MinimumTokenSimilarity,
    MixedTokenSimilarity,
    TokenSimilarityModifier,
    UnaryTokenSimilarityModifier,
)
from vectorian_tpu_torch.sim.span import (  # noqa: F401
    EmbeddedSpanSim,
    OptimizedSpanSim,
    SpanSim,
)
