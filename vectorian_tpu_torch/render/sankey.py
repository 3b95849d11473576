"""Sankey flow diagram of match token flows.

Reference: vectorian/render/sankey.py — holoviews/bokeh Sankey from
``match.flow`` edges.  holoviews is optional here: with it installed the
original interactive diagram is produced; without it a dependency-free
inline SVG fallback renders the same bipartite flow."""

from __future__ import annotations

import html

from vectorian_tpu_torch.render.utils import flow_edges


class FlowRenderer:
    def __init__(self, width: int = 600, row_height: int = 28, tolerance: float = 0.0):
        self._width = width
        self._row_height = row_height
        self._tolerance = tolerance

    @property
    def name(self):
        return "flow"

    def _edges(self, match):
        j = match.to_json()
        q_text, s_text = {}, {}
        for reg in j["regions"]:
            for e in reg.get("edges", ()):
                q_text[e["t"]["index"]] = e["t"]["text"]
        # s token texts by offset
        start, length = match.slice_span
        pd = match.prepared_doc
        doc = pd.doc
        for off in range(length):
            o = pd.orig_index[start + off]
            s_text[off] = doc.text[doc.idx[o] : doc.idx[o] + doc.len_[o]]
        out = []
        for t, s, f in flow_edges(match.flow, self._tolerance):
            out.append((q_text.get(t, str(t)), s_text.get(s, str(s)), f))
        return out

    def _holoviews_html(self, edges):  # pragma: no cover
        import holoviews as hv

        hv.extension("bokeh", logo=False)
        sankey = hv.Sankey([(a, b + " ", f) for a, b, f in edges])
        from holoviews.plotting import bokeh as hv_bokeh  # noqa: F401
        import bokeh.embed

        plot = hv.render(sankey)
        script, div = bokeh.embed.components(plot)
        return script + div

    def _svg_html(self, edges) -> str:
        if not edges:
            return "<div class='notification is-light'>no flow</div>"
        left = sorted({a for a, b, f in edges})
        right = sorted({b for a, b, f in edges})
        rh = self._row_height
        h = max(len(left), len(right)) * rh + rh
        w = self._width
        ly = {a: rh + i * rh for i, a in enumerate(left)}
        ry = {b: rh + i * rh for i, b in enumerate(right)}
        parts = [f'<svg width="{w}" height="{h}" xmlns="http://www.w3.org/2000/svg">']
        for a, b, f in edges:
            y1, y2 = ly[a], ry[b]
            sw = max(1.0, 6.0 * f)
            parts.append(
                f'<path d="M 150 {y1} C {w // 2} {y1}, {w // 2} {y2}, {w - 150} {y2}" '
                f'stroke="#3273dc" stroke-width="{sw:.1f}" fill="none" opacity="0.55"/>'
            )
        for a, y in ly.items():
            parts.append(
                f'<text x="145" y="{y + 4}" text-anchor="end" font-size="13">'
                f"{html.escape(a)}</text>"
            )
        for b, y in ry.items():
            parts.append(
                f'<text x="{w - 145}" y="{y + 4}" font-size="13">'
                f"{html.escape(b)}</text>"
            )
        parts.append("</svg>")
        return "".join(parts)

    def render_match(self, match) -> str:
        edges = self._edges(match)
        if not edges:
            # flow-less matches (e.g. SpanEncoderIndex) must not reach
            # holoviews — hv.Sankey([]) raises a DataError, not ImportError
            return "<div class='notification is-light'>no flow</div>"
        try:
            return self._holoviews_html(edges)
        except ImportError:
            return self._svg_html(edges)

    def to_html(self, result) -> str:
        return "\n".join(
            f"<div class='box'>{self.render_match(m)}</div>" for m in result
        )
