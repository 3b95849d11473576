"""The port's notebook query builder (``interact.py``) and ``LabSession``
against the JAX package, on the CPU, headless (no display).

The nine cases of tests/test_interact.py run on both packages with the
same widget settings: every widget's ``make()`` returns the port's spec
objects, ``describe()`` strings are equal, ``run()`` gives the same slices
with scores within 1e-6 and ``search_html()`` the same HTML once the
iframe's random frame id is normalized.  ``InteractiveQuery.run`` equals
the configured index's ``find`` byte for byte under affine and general
gaps; ``LabSession.run_query`` returns ``Session.run_query``'s matches.
"""

import re

import numpy as np
import pytest
import torch

pytest.importorskip("ipywidgets")

import IPython.display as ipd  # noqa: E402

import vectorian_tpu as vj  # noqa: E402
import vectorian_tpu_torch as vt  # noqa: E402
from vectorian_tpu import interact as jinteract  # noqa: E402
from vectorian_tpu_torch import alignment, interact  # noqa: E402
from vectorian_tpu_torch.index import ApproximateSpanIndex, SpanEncoderIndex  # noqa: E402
from vectorian_tpu_torch.sim import modifier  # noqa: E402
from vectorian_tpu_torch.sim.span import EmbeddedSpanSim, OptimizedSpanSim  # noqa: E402

from tests.helpers import word_vector  # noqa: E402
from tests.test_torch_slice import _pairs  # noqa: E402

torch.set_num_threads(2)

WORDS = ["the", "old", "king", "rides", "horse", "cat", "sleeps"]
TEXT = "the old king rides the horse. a cat sleeps."
FRAME_ID = re.compile(r"vtpu-[0-9a-f]+")


def _session(pkg, cls=None, **kw):
    embs = [pkg.KeyedVectors(name, WORDS, np.stack([word_vector(w, dim) for w in WORDS]))
            for name, dim in (("emb-a", 32), ("emb-b", 16))]
    return (cls or pkg.Session)([pkg.StringImporter()(TEXT, title="d")], embeddings=embs, **kw)


@pytest.fixture(scope="module")
def sessions():
    return _session(vj), _session(vt, device="cpu")


def _pair(sessions, configure=lambda iq: None):
    """Both packages' InteractiveQuery with the same widget settings."""
    sj, st = sessions
    iqj, iqt = jinteract.InteractiveQuery(sj), interact.InteractiveQuery(st)
    configure(iqj)
    configure(iqt)
    return iqj, iqt


def _assert_same_result(rj, rt):
    assert [s for s, _ in _pairs(rt)] == [s for s, _ in _pairs(rj)]
    np.testing.assert_allclose([m.score for m in rt], [m.score for m in rj], rtol=0, atol=1e-6)


def _run_both(iqj, iqt, text, n):
    rj, rt = iqj.run(text, n=n), iqt.run(text, n=n)
    _assert_same_result(rj, rt)
    assert iqt.describe() == iqj.describe()
    return rt


def test_interactive_query_builds_and_runs(sessions):
    iqj, iqt = _pair(sessions)
    assert iqt.widget is not None
    assert isinstance(iqt.make_span_sim().optimizer, alignment.LocalAlignment)
    r = _run_both(iqj, iqt, "old king rides horse", 5)
    assert len(r) >= 1 and r[0].score > 0.9


def test_mixer_and_algorithms(sessions):
    def configure(iq):
        iq._mixer._select.value = ("emb-a", "emb-b")
        iq._mixer._mode.value = "mixed"

    iqj, iqt = _pair(sessions, configure)
    assert isinstance(iqt._mixer.make(), modifier.MixedTokenSimilarity)
    _run_both(iqj, iqt, "king rides horse", 3)
    for iq in (iqj, iqt):
        iq._alignment._algo.value = "word rotator's distance"
    assert isinstance(iqt._alignment.make(), alignment.WordRotatorsDistance)
    _run_both(iqj, iqt, "king rides horse", 3)

    awj, awt = jinteract.AlignmentWidget(), interact.AlignmentWidget()
    assert interact.AlignmentWidget.ALGOS == jinteract.AlignmentWidget.ALGOS
    for algo in interact.AlignmentWidget.ALGOS:
        awj._algo.value = awt._algo.value = algo
        got, want = awt.make(), awj.make()
        assert type(got).__name__ == type(want).__name__
        assert type(got).__module__ == "vectorian_tpu_torch.alignment"
        assert awt.describe() == awj.describe()


class _FakeIndex:
    def __init__(self, session):
        self.partition = session.partition("sentence")


def test_falloff_and_gap_mask(sessions):
    iqj, iqt = _pair(sessions, lambda iq: setattr(iq._mixer._falloff, "value", 2.0))
    assert isinstance(iqt._mixer.make(), modifier.UnaryTokenSimilarityModifier)
    assert len(_run_both(iqj, iqt, "old king rides horse", 3)) >= 1

    def mask(iq):
        aw = iq._alignment
        aw._gap_s._value.value = 0.8
        aw._gap_t._value.value = 0.8
        aw._mask_s.value = False

    mask(iqj)
    mask(iqt)
    g = iqt.make_span_sim().to_args(_FakeIndex(sessions[1]))["alignment"]
    assert g["gap_s"].costs(4)[1] == pytest.approx(0.0)
    assert g["gap_t"].costs(4)[1] == pytest.approx(0.8)
    _run_both(iqj, iqt, "old king rides horse", 3)


def _strip(page):
    return FRAME_ID.sub("vtpu-X", page)


def test_render_spec_widget(sessions):
    iqj, iqt = _pair(sessions)
    qj, qt = iqj._query, iqt._query
    qj._renderers.value = qt._renderers.value = ("excerpt", "flow")
    assert qt.render_spec() == "excerpt, flow"
    qj._annotate.value = qt._annotate.value = True
    assert qt.render_spec() == qj.render_spec() == "excerpt +tags +metric, flow"
    got = iqt.run("old king rides horse", n=2).format(qt.render_spec())._repr_html_()
    want = iqj.run("old king rides horse", n=2).format(qj.render_spec())._repr_html_()
    assert "king" in got and _strip(got) == _strip(want)


def test_tag_weights_widget(sessions):
    iqj, iqt = _pair(sessions, lambda iq: setattr(iq._tags._enabled, "value", True))
    opts = iqt._tags.make()
    assert opts["tag_weights"] == interact.POST_STSS_TAG_WEIGHTS == jinteract.POST_STSS_TAG_WEIGHTS
    assert iqt.make_span_sim().tag_weights == interact.POST_STSS_TAG_WEIGHTS
    r = _run_both(iqj, iqt, "the old king rides the horse", 3)
    assert len(r) >= 1 and 0.5 < r[0].score <= 1.0


def test_describe(sessions):
    iqj, iqt = _pair(sessions, lambda iq: setattr(iq._tags._enabled, "value", True))
    d = iqt.describe()
    assert d == iqj.describe()
    assert "local alignment" in d and "cosine" in d and "POST-STSS" in d
    assert "sentence partition" in d
    assert interact.VECTOR_METRICS.keys() == jinteract.VECTOR_METRICS.keys()


@pytest.mark.parametrize("mix,weights", [(0.8, [0.2, 0.8]), (0.5, [0.5, 0.5])])
def test_mixer_weights_any_k(sessions, mix, weights):
    sj, st = sessions
    wt = interact.EmbeddingMixerWidget(st, interact.VectorMetricWidget())
    wj = jinteract.EmbeddingMixerWidget(sj, jinteract.VectorMetricWidget())
    for w in (wj, wt):
        w._select.value = ("emb-a", "emb-b")
        w._mode.value = "mixed"
        w._mix.value = mix
    assert wt.make()._weights == pytest.approx(weights)
    assert wt.make()._weights == wj.make()._weights
    assert wt.describe() == wj.describe()


def test_query_widget_search_button_event(sessions, monkeypatch):
    """The Search button's widget event path: Button.click() fires
    _on_search, which runs the configured query and displays the rendered
    HTML, recorded through IPython.display."""

    def configure(iq):
        qw = iq._query
        qw._text.value = "old king rides horse"
        qw._n.value = 3
        qw._renderers.value = ("excerpt", "flow")
        qw._annotate.value = True

    iqj, iqt = _pair(sessions, configure)
    shown = []
    monkeypatch.setattr(ipd, "display", lambda obj: shown.append(obj))
    iqt._query._button.click()
    assert shown, "search button displayed nothing"
    page = shown[0].data
    assert "king" in page and "<" in page
    assert _strip(iqt._query.search_html()) == _strip(page)
    assert _strip(page) == _strip(iqj._query.search_html())


def test_span_strategy_widget_embedding_search(sessions):
    def configure(iq):
        iq._strategy._strategy.value = "partition embedding"
        iq._strategy._emb.value = "emb-a"

    iqj, iqt = _pair(sessions, configure)
    assert isinstance(iqt.make_span_sim(), EmbeddedSpanSim)
    assert isinstance(iqt.make_index(), SpanEncoderIndex)
    r = _run_both(iqj, iqt, "the old king rides the horse", 2)
    assert len(r) >= 1 and r[0].score > 0.9
    assert "partition embeddings" in iqt.describe()

    for iq in (iqj, iqt):
        iq._strategy._approx.value = True
        iq._strategy._nlist.value = 4
        iq._strategy._nprobe.value = 4
    assert isinstance(iqt.make_index(), ApproximateSpanIndex)
    assert len(_run_both(iqj, iqt, "the old king rides the horse", 2)) >= 1
    assert "IVF shortlist" in iqt.describe()

    iqt._strategy._strategy.value = "alignment"
    assert isinstance(iqt.make_span_sim(), OptimizedSpanSim)


@pytest.mark.parametrize("gap", ["constant", "exponential"])
def test_run_is_the_configured_index_find(sessions, gap):
    """``run`` is ``make_index().find`` byte for byte, under an affine and a
    general-gap (``ExponentialGapCost``) alignment."""

    def configure(iq):
        iq._alignment._gap_s._kind.value = gap
        iq._alignment._gap_t._kind.value = gap
        iq._alignment._gap_s._value.value = 0.3

    iqj, iqt = _pair(sessions, configure)
    if gap == "exponential":
        assert isinstance(iqt._alignment.make().gap["s"], alignment.ExponentialGapCost)
    for q in ("old king rides horse", "a cat sleeps", "horse"):
        got = _pairs(iqt.run(q, n=3))
        assert got == _pairs(iqt.make_index().find(q, n=3))
        _assert_same_result(iqj.run(q, n=3), iqt.run(q, n=3))


def test_lab_session_run_query_shows_progress(monkeypatch):
    lab = _session(vt, vt.LabSession, device="cpu")
    plain = _session(vt, device="cpu")
    assert isinstance(lab, vt.Session)

    def find(session):
        return session.partition("sentence").index(
            vt.metrics.EmbeddingTokenSim(session.embeddings[0])).find

    shown = []
    monkeypatch.setattr(ipd, "display", lambda obj: shown.append(obj))
    r = lab.run_query(find(lab), "old king rides horse")
    want = plain.run_query(find(plain), "old king rides horse")
    assert _pairs(r) == _pairs(want) and len(r) >= 1
    assert [type(w).__name__ for w in shown] == ["FloatProgress"]
    assert r.duration >= 0.0 and r.index is None

    # without ipywidgets it is Session.run_query
    monkeypatch.setitem(__import__("sys").modules, "ipywidgets", None)
    shown.clear()
    assert _pairs(lab.run_query(find(lab), "old king rides horse")) == _pairs(want)
    assert not shown
