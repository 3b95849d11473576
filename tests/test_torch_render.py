"""The port's renderers (``render/``) and ``Result.format`` /
``Result._repr_html_`` against the JAX package's, on the CPU.

Every case of tests/test_render.py runs on both packages' results of the
same query over the same documents: alignment matches (injective flows)
and relaxed-WMD matches (sparse flows, of unit or fractional mass).
Excerpt, flow and iframe HTML are equal byte for byte once the iframe's
random frame id is normalized;
matrix specs (``json.dumps`` of float flows at full precision) are equal as
parsed JSON with numbers within 1e-6.
"""

import html
import json
import re

import numpy as np
import pytest
import torch

import vectorian_tpu as vj
import vectorian_tpu_torch as vt
from vectorian_tpu import render as jrender
from vectorian_tpu.alignment import WordMoversDistance as JaxWMD
from vectorian_tpu.render.location import to_roman as jax_to_roman
from vectorian_tpu.sim.span import OptimizedSpanSim as JaxSpanSim
from vectorian_tpu.sim.token import EmbeddingTokenSim as JaxTokenSim
from vectorian_tpu_torch import render as trender
from vectorian_tpu_torch.alignment import WordMoversDistance
from vectorian_tpu_torch.render.location import to_roman
from vectorian_tpu_torch.sim.span import OptimizedSpanSim
from vectorian_tpu_torch.sim.token import EmbeddingTokenSim

from tests.helpers import word_vector
from tests.test_torch_slice import _pairs

torch.set_num_threads(2)

WORDS = ["the", "old", "king", "rides", "grey", "horse", "cat", "sleeps", "a", "young",
         "queen", "walks", "black", "dog"]
TEXTS = ["the old king rides the grey horse. a cat sleeps.",
         "the young queen walks a black dog.\nthe old dog sleeps. a king rides."]
QUERY = "old king rides horse"
FRAME_ID = re.compile(r"vtpu-[0-9a-f]{8}")
SPEC = re.compile(r"vegaEmbed\('#(vtpu-matrix-\d+)', (\{.*?\})\);</script>", re.S)


def _session(pkg, **kw):
    emb = pkg.KeyedVectors("toy", WORDS, np.stack([word_vector(w, 16) for w in WORDS]))
    docs = [pkg.StringImporter()(t, title=f"doc {i}") for i, t in enumerate(TEXTS)]
    return pkg.Session(docs, embeddings=[emb], **kw)


@pytest.fixture(scope="module")
def sessions():
    return _session(vj), _session(vt, device="cpu")


TRANSPORT = {"rwmd": (JaxWMD, WordMoversDistance),
             "rwmd-nbow": (lambda: JaxWMD.rwmd("nbow"), lambda: WordMoversDistance.rwmd("nbow"))}


@pytest.fixture(scope="module", params=["alignment", "rwmd", "rwmd-nbow"])
def results(request, sessions):
    """(JAX result, port result) of one query: the default alignment, or
    relaxed WMD (unit flows; nbow: fractional flows), with the same slices
    and scores within 1e-6."""
    sj, st = sessions
    if request.param == "alignment":
        ij = sj.partition("sentence").index(JaxTokenSim(sj.embeddings[0]))
        it = st.partition("sentence").index(EmbeddingTokenSim(st.embeddings[0]))
    else:
        mk_j, mk_t = TRANSPORT[request.param]
        ij = sj.partition("sentence").index(JaxSpanSim(JaxTokenSim(sj.embeddings[0]), mk_j()))
        it = st.partition("sentence").index(
            OptimizedSpanSim(EmbeddingTokenSim(st.embeddings[0]), mk_t()))
    rj, rt = ij.find(QUERY, n=3), it.find(QUERY, n=3)
    assert len(rt) >= 2
    assert [s for s, _ in _pairs(rj)] == [s for s, _ in _pairs(rt)]
    np.testing.assert_allclose([m.score for m in rt], [m.score for m in rj], rtol=0, atol=1e-6)
    assert {m.flow["type"] for m in rt} == {"injective" if request.param == "alignment"
                                           else "sparse"}
    return rj, rt


def _close(a, b, tol=1e-6):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _close(a[k], b[k], tol) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _close(x, y, tol) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= tol
    return a == b


def _split_specs(page):
    """(page with each matrix spec replaced by its div id and the frame id
    normalized, [the specs as parsed JSON]) — the page html-unescaped first,
    so that an iframe's srcdoc reads as its HTML."""
    page = FRAME_ID.sub("vtpu-X", html.unescape(page))
    specs = [json.loads(m.group(2)) for m in SPEC.finditer(page)]
    return SPEC.sub(lambda m: m.group(1), page), specs


def _assert_same_page(got, want):
    got_page, got_specs = _split_specs(got)
    want_page, want_specs = _split_specs(want)
    assert got_page == want_page
    assert _close(got_specs, want_specs)


@pytest.mark.parametrize("annotate", [(), ("tags",), ("tags", "metric", "penalties")])
def test_excerpt_renderer_matches_jax(results, annotate):
    rj, rt = results
    got = trender.ExcerptRenderer(*annotate).to_html(rt)
    assert got == jrender.ExcerptRenderer(*annotate).to_html(rj)
    assert "king" in got and "has-text-weight-bold" in got
    assert got.count("<div class='box'>") == len(rt)
    assert "tag is-success" in got  # an exact word's edge


def test_full_renderer_iframe_matches_jax(results):
    rj, rt = results
    got = trender.Renderer([trender.ExcerptRenderer()]).to_html(rt)
    want = jrender.Renderer([jrender.ExcerptRenderer()]).to_html(rj)
    assert "<iframe" in got and "srcdoc=" in got and "bulma" in got
    assert FRAME_ID.search(got)
    assert FRAME_ID.sub("vtpu-X", got) == FRAME_ID.sub("vtpu-X", want)


def test_flow_renderer_svg_matches_jax(results):
    rj, rt = results
    got = trender.FlowRenderer().to_html(rt)
    assert got == jrender.FlowRenderer().to_html(rj)
    assert "<svg" in got and "king" in got
    for m in rt:
        svg = trender.FlowRenderer().render_match(m)
        assert svg.count("<path ") == len(list(trender.flow_edges(m.flow)))


def test_matrix_spec_matches_jax(results):
    rj, rt = results
    for mj, mt in zip(rj, rt):
        spec = trender.matrix_spec(mt)
        assert spec["mark"] == "rect"
        assert len(spec["data"]["values"]) == len(list(trender.flow_edges(mt.flow)))
        assert _close(spec, jrender.matrix_spec(mj))
    assert len(trender.matrix_spec(rt[0])["data"]["values"]) >= 3
    got = trender.MatrixRenderer().to_html(rt)
    assert "vegaEmbed" in got
    _assert_same_page(got, jrender.MatrixRenderer().to_html(rj))


def test_result_repr_html_matches_jax(results):
    rj, rt = results
    got = rt._repr_html_()
    assert "<iframe" in got
    _assert_same_page(got, rj._repr_html_())


@pytest.mark.parametrize("spec", ["excerpt +tags +metric, flow, matrix", "flow", "matrix ,excerpt"])
def test_result_format_spec_string_matches_jax(results, spec):
    rj, rt = results
    ft = rt.format(spec)
    assert list(ft) == list(rt) and ft.duration == rt.duration
    names = [n.split()[0] for n in spec.split(",")]
    assert [r.name for r in ft._renderers] == names
    _assert_same_page(ft._repr_html_(), rj.format(spec)._repr_html_())


def test_result_format_renderer_list_matches_jax(results):
    rj, rt = results
    ft = rt.format([trender.FlowRenderer(width=400), trender.ExcerptRenderer("tags")])
    fj = rj.format([jrender.FlowRenderer(width=400), jrender.ExcerptRenderer("tags")])
    _assert_same_page(ft._repr_html_(), fj._repr_html_())


@pytest.mark.parametrize("spec,error", [("excerpt tags", ValueError), ("excerpt +tags, flow x", ValueError),
                                        ("sankey", KeyError)])
def test_result_format_rejects_a_bad_spec_as_jax_does(results, spec, error):
    rj, rt = results
    with pytest.raises(error):
        rt.format(spec)
    with pytest.raises(error):
        rj.format(spec)


@pytest.mark.parametrize("flow", [
    {"type": "injective", "target": [2, -1, 0], "flow": [1.0, 1.0, 0.5]},
    {"type": "sparse", "edges": [{"t": 0, "s": 1, "flow": 0.25}, {"t": 1, "s": 0, "flow": 0.0}]},
    {"type": "dense", "flow": np.array([[0.0, 0.5], [0.25, 0.0]], np.float32)},
    None,
], ids=["injective", "sparse", "dense", "none"])
def test_flow_edges_matches_jax(flow):
    assert list(trender.flow_edges(flow, 0.1)) == list(jrender.flow_edges(flow, 0.1))
    assert list(trender.flow_edges(flow)) == list(jrender.flow_edges(flow))


def test_flow_edges_rejects_an_unknown_flow_type():
    with pytest.raises(ValueError):
        list(trender.flow_edges({"type": "other"}))


def test_location_formatter_matches_jax():
    fmt, jfmt = trender.LocationFormatter(), jrender.LocationFormatter()

    class Doc:
        metadata = {}

    locations = [{"speaker": "HAMLET", "act": 3, "scene": 1}, {"speaker": "GHOST"},
                 {"book": 2, "chapter": 5}, {"chapter": 7}, {"heading": "Intro"},
                 {"slice_start": 12}, {}]
    got = [fmt(Doc(), loc) for loc in locations]
    assert got == [jfmt(Doc(), loc) for loc in locations]
    assert got[0].speaker == "HAMLET" and got[0].location == "III.1"
    assert got[2].location == "Book 2, Chapter 5" and got[4].location == "Intro"
    assert got[-1] is None
    fmt.add(lambda doc, loc: trender.Location("me", "here"))
    assert fmt(Doc(), {}) == ("me", "here")
    assert to_roman(1994) == "MCMXCIV"
    assert [to_roman(n) for n in range(1, 400)] == [jax_to_roman(n) for n in range(1, 400)]
