"""Interactive ipywidgets query builder.

Reference: vectorian/interact.py (1148 LoC) — a GUI mirroring the spec
layer: vector metric picker, embedding mixers (mixed/max/min with falloff),
gap-cost widgets, alignment algorithms incl. WMD variants and WRD,
tag-weighted alignment with the Batanović et al. POST-STSS default tag
weights (interact.py:794-803), partition widget and result pane.

Every widget owns a ``make()`` producing the corresponding spec object, so
the GUI is a thin layer over the same API users script against."""

from __future__ import annotations

from typing import Optional

from vectorian_tpu_torch.alignment import (
    ConstantGapCost,
    ExponentialGapCost,
    GlobalAlignment,
    LinearGapCost,
    LocalAlignment,
    SemiGlobalAlignment,
    WordMoversDistance,
    WordRotatorsDistance,
)
from vectorian_tpu_torch.sim.kernel import (
    Bias,
    DistanceToSimilarity,
    Power,
    RadialBasis,
    Scale,
)
from vectorian_tpu_torch.sim.modifier import (
    MaximumTokenSimilarity,
    MinimumTokenSimilarity,
    MixedTokenSimilarity,
    UnaryTokenSimilarityModifier,
)
from vectorian_tpu_torch.sim.span import OptimizedSpanSim
from vectorian_tpu_torch.sim.token import EmbeddingTokenSim
from vectorian_tpu_torch.sim.vector import (
    CosineSim,
    FuzzyJaccardSim,
    ImprovedSqrtCosineSim,
    ModifiedVectorSim,
    PNormDistance,
)

# Batanović et al. POST-STSS tag weights (reference interact.py:794-803)
POST_STSS_TAG_WEIGHTS = {
    "CC": 0.7, "CD": 0.8, "DT": 0.7, "EX": 0.7, "FW": 0.7, "IN": 0.7,
    "JJ": 0.7, "JJR": 0.7, "JJS": 0.8, "LS": 0.7, "MD": 1.2, "NN": 0.8,
    "NNS": 1.0, "NNP": 0.8, "NNPS": 0.8, "PDT": 0.7, "POS": 0.7,
    "PRP": 0.7, "PRP$": 0.7, "RB": 1.3, "RBR": 1.2, "RBS": 1.0, "RP": 1.2,
    "SYM": 0.7, "TO": 0.8, "UH": 0.7, "VB": 1.2, "VBD": 1.2, "VBG": 1.1,
    "VBN": 0.8, "VBP": 1.2, "VBZ": 1.2, "WDT": 0.7, "WP": 0.7, "WP$": 0.7,
    "WRB": 1.3,
}

VECTOR_METRICS = {
    "cosine": CosineSim,
    "improved-sqrt-cosine": ImprovedSqrtCosineSim,
    "fuzzy-jaccard": FuzzyJaccardSim,
    "p-norm (euclidean)": lambda: ModifiedVectorSim(
        PNormDistance(2), DistanceToSimilarity()
    ),
}


def _widgets():
    try:
        import ipywidgets
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "InteractiveQuery requires ipywidgets (notebook environment)"
        ) from e
    return ipywidgets


class VectorMetricWidget:
    def __init__(self):
        w = _widgets()
        self._dropdown = w.Dropdown(
            options=list(VECTOR_METRICS.keys()),
            value="cosine",
            description="Vector Metric:",
        )
        self._rbf = w.FloatSlider(
            value=0.0, min=0.0, max=10.0, step=0.5, description="RBF gamma (0=off):"
        )
        self.widget = w.VBox([self._dropdown, self._rbf])

    def make(self):
        metric = VECTOR_METRICS[self._dropdown.value]()
        if self._rbf.value > 0:
            metric = ModifiedVectorSim(
                metric, DistanceToSimilarity(), RadialBasis(self._rbf.value)
            )
        return metric

    def describe(self) -> str:
        s = f"the **{self._dropdown.value}** vector metric"
        if self._rbf.value > 0:
            s += f" through an RBF kernel (gamma={self._rbf.value:g})"
        return s


class EmbeddingMixerWidget:
    """Pick embeddings and how to combine them (reference
    interact.py:271-430: mixed / max / min + falloff power)."""

    def __init__(self, session, metric_widget: VectorMetricWidget):
        w = _widgets()
        self._session = session
        self._metric_widget = metric_widget
        names = [e.name for e in session.embeddings]
        self._select = w.SelectMultiple(
            options=names, value=tuple(names[:1]), description="Embeddings:"
        )
        self._mode = w.Dropdown(
            options=["single", "mixed", "maximum", "minimum"],
            value="single",
            description="Combine:",
        )
        self._mix = w.FloatSlider(
            value=0.5, min=0.0, max=1.0, step=0.05, description="Mix:"
        )
        # reference interact.py:312-327: log-scale Power falloff on the
        # combined similarity
        self._falloff = w.FloatLogSlider(
            value=1.0, base=2, min=-2, max=2, step=0.25, description="Falloff:"
        )
        self.widget = w.VBox([self._select, self._mode, self._mix, self._falloff])

    def make(self) -> EmbeddingTokenSim:
        by_name = {e.name: e for e in self._session.embeddings}
        chosen = [by_name[n] for n in self._select.value] or list(by_name.values())[:1]
        metric = self._metric_widget.make()
        sims = [EmbeddingTokenSim(e, metric) for e in chosen]
        if len(sims) == 1 or self._mode.value == "single":
            sim = sims[0]
        elif self._mode.value == "mixed":
            # one Mix slider for any k: 0 = all weight on the first
            # selected embedding, 0.5 = uniform, 1 = all on the last
            # (reduces exactly to [1-m, m] for two embeddings; the
            # reference's per-embedding sliders map onto this single knob)
            k = len(sims)
            m = self._mix.value
            t = abs(m - 0.5) * 2.0
            pole = k - 1 if m >= 0.5 else 0
            weights = [
                (1.0 - t) / k + (t if i == pole else 0.0) for i in range(k)
            ]
            sim = MixedTokenSimilarity(sims, weights)
        elif self._mode.value == "maximum":
            sim = MaximumTokenSimilarity(sims)
        else:
            sim = MinimumTokenSimilarity(sims)
        if abs(self._falloff.value - 1.0) > 1e-9:
            sim = UnaryTokenSimilarityModifier(sim, [Power(self._falloff.value)])
        return sim

    def describe(self) -> str:
        names = ", ".join(self._select.value) or "the first embedding"
        s = f"**{names}**"
        if len(self._select.value) > 1 and self._mode.value != "single":
            s += f" combined via **{self._mode.value}**"
        if abs(self._falloff.value - 1.0) > 1e-9:
            s += f", with a falloff of {self._falloff.value:.2f}"
        return s


class GapCostWidget:
    """Gap cost model editor with preview plot (reference interact.py:433-529)."""

    def __init__(self, label="Gap:"):
        w = _widgets()
        self._kind = w.Dropdown(
            options=["constant", "linear", "exponential"],
            value="constant",
            description=label,
        )
        self._value = w.FloatSlider(
            value=0.0, min=0.0, max=2.0, step=0.05, description="cost:"
        )
        # exponential uses a CUTOFF (gap length at which the cost saturates),
        # not a per-step cost — a separate slider like the reference's
        # 'Cutoff:' (interact.py:472-487, default 3)
        self._cutoff = w.IntSlider(
            value=3, min=1, max=21, step=1, description="cutoff:"
        )
        self.widget = w.HBox([self._kind, self._value, self._cutoff])

    def make(self):
        v = self._value.value
        if self._kind.value == "constant":
            return ConstantGapCost(v)
        if self._kind.value == "linear":
            return LinearGapCost(v)
        return ExponentialGapCost(self._cutoff.value)

    def plot(self):  # pragma: no cover
        import matplotlib.pyplot as plt

        c = self.make().costs(32)
        plt.plot(range(len(c)), c)
        plt.xlabel("gap length")
        plt.ylabel("cost")


class AlignmentWidget:
    """Algorithm picker incl. WMD variants / WRD (reference
    interact.py:584-780)."""

    ALGOS = [
        "local alignment (Smith-Waterman)",
        "global alignment (Needleman-Wunsch)",
        "semiglobal alignment",
        "rwmd (nbow)",
        "rwmd (nbow, distributed)",
        "rwmd (bow, fast)",
        "wmd (nbow)",
        "wmd (bow)",
        "word rotator's distance",
    ]

    def __init__(self):
        w = _widgets()
        self._algo = w.Dropdown(
            options=self.ALGOS, value=self.ALGOS[0], description="Alignment:"
        )
        self._gap_s = GapCostWidget("Gap (doc):")
        self._gap_t = GapCostWidget("Gap (query):")
        # gap mask (reference GapMaskWidget, interact.py:532-550 + :623-627):
        # an unmasked side gets free gaps (ConstantGapCost(0))
        self._mask_s = w.Checkbox(value=True, description="penalize doc gaps (s)")
        self._mask_t = w.Checkbox(value=True, description="penalize query gaps (t)")
        self.widget = w.VBox(
            [
                self._algo,
                self._gap_s.widget,
                self._gap_t.widget,
                w.HBox([self._mask_s, self._mask_t]),
            ]
        )

    def make(self):
        a = self._algo.value
        gap = {
            "s": self._gap_s.make() if self._mask_s.value else ConstantGapCost(0),
            "t": self._gap_t.make() if self._mask_t.value else ConstantGapCost(0),
        }
        if a.startswith("local"):
            return LocalAlignment(gap)
        if a.startswith("global"):
            return GlobalAlignment(gap)
        if a.startswith("semiglobal"):
            return SemiGlobalAlignment(gap)
        if a == "rwmd (nbow)":
            return WordMoversDistance.rwmd("nbow")
        if a == "rwmd (nbow, distributed)":
            return WordMoversDistance.rwmd("nbow/distributed")
        if a == "rwmd (bow, fast)":
            return WordMoversDistance.rwmd("bow/fast")
        if a == "wmd (nbow)":
            return WordMoversDistance.wmd("nbow")
        if a == "wmd (bow)":
            return WordMoversDistance.wmd("bow")
        return WordRotatorsDistance()

    def describe(self) -> str:
        s = f"**{self._algo.value}**"
        if self._algo.value.split()[0] in ("local", "global", "semiglobal"):
            def side(gap_w, masked):
                if masked:
                    return "free"
                return f"{gap_w._kind.value} {gap_w._value.value:g}"

            s += (
                f" with gap costs (doc: {side(self._gap_s, not self._mask_s.value)}, "
                f"query: {side(self._gap_t, not self._mask_t.value)})"
            )
        return s


class TagWeightsWidget:
    """Tag-weighted alignment options (reference interact.py:783-852)."""

    def __init__(self):
        w = _widgets()
        self._enabled = w.Checkbox(value=False, description="Tag weights (POST-STSS)")
        self._penalty = w.FloatSlider(
            value=1.0, min=0.0, max=1.0, step=0.1, description="POS Mismatch Penalty:"
        )
        self._threshold = w.FloatSlider(
            value=0.2, min=0.0, max=1.0, step=0.1, description="Similarity Threshold:"
        )
        self.widget = w.VBox([self._enabled, self._penalty, self._threshold])

    def make(self) -> dict:
        if not self._enabled.value:
            return {}
        return {
            "tag_weights": dict(POST_STSS_TAG_WEIGHTS),
            "pos_mismatch_penalty": self._penalty.value,
            "similarity_threshold": self._threshold.value,
        }


class PartitionWidget:
    def __init__(self, session):
        w = _widgets()
        self._session = session
        self._level = w.Dropdown(
            options=["sentence", "token", "document"],
            value="sentence",
            description="Level:",
        )
        self._size = w.IntSlider(value=1, min=1, max=10, description="Window size:")
        self._step = w.IntSlider(value=1, min=1, max=10, description="Window step:")
        self.widget = w.VBox([self._level, self._size, self._step])

    def make(self):
        return self._session.partition(
            self._level.value, self._size.value, self._step.value
        )


class SpanStrategyWidget:
    """Span-similarity strategy: token-level Alignment (the default
    pipeline below) or whole-span Partition Embedding search (reference
    PartitionMetricWidget strategy dropdown, interact.py:878-891, and
    PartitionEmbeddingWidget :855-876 — there the encoder registry feeds
    EmbeddedSpanSim; here the pooled-token span encoder plus an optional
    IVF shortlist replace the Faiss factory)."""

    def __init__(self, session):
        w = _widgets()
        self._session = session
        self._strategy = w.Dropdown(
            options=["alignment", "partition embedding"],
            value="alignment",
            description="Strategy:",
        )
        names = [
            e.name for e in session.embeddings
            if getattr(e, "is_static", True)
        ]
        self._emb = w.Dropdown(
            options=names or ["(none)"],
            value=(names or ["(none)"])[0],
            description="Model:",
        )
        self._agg = w.Dropdown(
            options=["mean", "min", "max"], value="mean",
            description="Pooling:",
        )
        self._approx = w.Checkbox(
            value=False, description="Approximate (IVF shortlist)"
        )
        self._nlist = w.IntSlider(
            value=64, min=4, max=1024, description="IVF lists:"
        )
        self._nprobe = w.IntSlider(
            value=8, min=1, max=64, description="IVF probes:"
        )
        self.widget = w.VBox(
            [self._strategy, self._emb, self._agg, self._approx,
             self._nlist, self._nprobe]
        )

    @property
    def is_embedding(self) -> bool:
        return self._strategy.value == "partition embedding"

    def make(self):
        from vectorian_tpu_torch.embedding.span import AggregatedTokenEmbedding
        from vectorian_tpu_torch.sim.span import EmbeddedSpanSim

        by_name = {e.name: e for e in self._session.embeddings}
        emb = by_name[self._emb.value]
        return EmbeddedSpanSim(AggregatedTokenEmbedding(emb, self._agg.value))

    def index_kwargs(self) -> dict:
        if self._approx.value:
            return {
                "approximate": {
                    "nlist": self._nlist.value,
                    "nprobe": self._nprobe.value,
                }
            }
        return {}

    def describe(self) -> str:
        s = (
            f"partition embeddings using **{self._emb.value}** "
            f"({self._agg.value}-pooled)"
        )
        if self._approx.value:
            s += (
                f", approximate IVF shortlist ({self._nlist.value} lists, "
                f"{self._nprobe.value} probes)"
            )
        return s


class QueryWidget:
    """Query box + result pane (reference interact.py:985-1112)."""

    def __init__(self, iquery: "InteractiveQuery"):
        w = _widgets()
        self._iquery = iquery
        self._text = w.Text(
            value="", placeholder="enter a search phrase", description="Query:",
            layout=w.Layout(width="60%"),
        )
        self._n = w.IntSlider(value=10, min=1, max=100, description="Matches:")
        # renderer toggles (reference result-pane format options)
        self._renderers = w.SelectMultiple(
            options=["excerpt", "flow", "matrix"],
            value=("excerpt",),
            description="Render:",
        )
        self._annotate = w.Checkbox(value=False, description="annotate tags/metrics")
        self._button = w.Button(description="Search", button_style="primary")
        self._output = w.Output()
        self._button.on_click(self._on_search)
        self.widget = w.VBox(
            [
                w.HBox([self._text, self._button]),
                self._n,
                w.HBox([self._renderers, self._annotate]),
                self._output,
            ]
        )

    def render_spec(self) -> str:
        names = list(self._renderers.value) or ["excerpt"]
        if self._annotate.value:
            names = [
                "excerpt +tags +metric" if n == "excerpt" else n for n in names
            ]
        return ", ".join(names)

    def search_html(self) -> str:
        """Run the configured query and return the rendered result HTML —
        the testable core of the Search button (reference result pane,
        interact.py:985-1113)."""
        result = self._iquery.run(self._text.value, n=self._n.value)
        return result.format(self.render_spec())._repr_html_()

    def _on_search(self, _event=None):
        from IPython.display import HTML, display

        self._output.clear_output()
        with self._output:
            display(HTML(self.search_html()))


class InteractiveQuery:
    """The full query-builder GUI (reference interact.py:1115-1148)."""

    def __init__(self, session, nlp=None):
        self._session = session
        self._nlp = nlp
        self._metric = VectorMetricWidget()
        self._mixer = EmbeddingMixerWidget(session, self._metric)
        self._strategy = SpanStrategyWidget(session)
        self._alignment = AlignmentWidget()
        self._tags = TagWeightsWidget()
        self._partition = PartitionWidget(session)
        self._query = QueryWidget(self)

    @property
    def session(self):
        return self._session

    def make_span_sim(self):
        if self._strategy.is_embedding:
            return self._strategy.make()
        return OptimizedSpanSim(
            self._mixer.make(), self._alignment.make(), **self._tags.make()
        )

    def make_index(self):
        kwargs = (
            self._strategy.index_kwargs()
            if self._strategy.is_embedding
            else {}
        )
        return self._partition.make().index(
            self.make_span_sim(), nlp=self._nlp, **kwargs
        )

    def run(self, text: str, n: int = 10):
        return self.make_index().find(text, n=n)

    def describe(self) -> str:
        """Prose summary of the configured query (reference interact.py
        describe() chains)."""
        if self._strategy.is_embedding:
            parts = ["Matching with", self._strategy.describe()]
            parts.append(
                f"on the {self._partition._level.value} partition "
                f"(window {self._partition._size.value}, "
                f"step {self._partition._step.value})."
            )
            return " ".join(parts)
        parts = [
            "Matching with", self._alignment.describe(),
            "over", self._mixer.describe(),
            "scored by", self._metric.describe(),
        ]
        tw = self._tags.make()
        if tw:
            parts.append(
                f"with POST-STSS tag weights (pos mismatch penalty "
                f"{tw['pos_mismatch_penalty']:g}, similarity threshold "
                f"{tw['similarity_threshold']:g})"
            )
        parts.append(
            f"on the {self._partition._level.value} partition "
            f"(window {self._partition._size.value}, "
            f"step {self._partition._step.value})."
        )
        return " ".join(parts)

    @property
    def widget(self):
        w = _widgets()
        return w.VBox(
            [
                w.HTML("<b>Metric</b>"),
                self._metric.widget,
                self._mixer.widget,
                w.HTML("<b>Strategy</b>"),
                self._strategy.widget,
                w.HTML("<b>Alignment</b>"),
                self._alignment.widget,
                self._tags.widget,
                w.HTML("<b>Partition</b>"),
                self._partition.widget,
                w.HTML("<b>Query</b>"),
                self._query.widget,
            ]
        )

    def _ipython_display_(self):  # pragma: no cover
        from IPython.display import display

        display(self.widget)
