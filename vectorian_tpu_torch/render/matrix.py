"""Adjacency-matrix visualization of match flows.

Reference: vectorian/render/matrix.py + vega.py + vega/matrix.json — a vega
spec rendering the (query token x document token) flow matrix.  The spec is
generated as a plain dict (rendered by any vega-embed-capable frontend,
e.g. Jupyter's vega mimetype); no python-side vega dependency needed."""

from __future__ import annotations

from vectorian_tpu_torch.render.utils import flow_edges


def matrix_spec(match, tolerance: float = 0.0) -> dict:
    """Vega-Lite heatmap spec for one match's flow."""
    flow = match.flow
    values = []
    if flow is not None:
        j = match.to_json()
        q_tokens = {}
        for reg in j["regions"]:
            for e in reg.get("edges", ()):
                q_tokens[e["t"]["index"]] = e["t"]["text"]
        for t, s, f in flow_edges(flow, tolerance):
            values.append(
                {
                    "t": q_tokens.get(t, str(t)),
                    "t_index": t,
                    "s": s,
                    "flow": f,
                }
            )
    return {
        "$schema": "https://vega.github.io/schema/vega-lite/v5.json",
        "data": {"values": values},
        "mark": "rect",
        "encoding": {
            "x": {"field": "s", "type": "ordinal", "title": "document token"},
            "y": {"field": "t", "type": "ordinal", "title": "query token"},
            "color": {
                "field": "flow",
                "type": "quantitative",
                "scale": {"scheme": "blues"},
            },
        },
    }


class MatrixRenderer:
    def __init__(self, tolerance: float = 0.0):
        self._tolerance = tolerance

    @property
    def name(self):
        return "matrix"

    def to_html(self, result) -> str:
        import json

        parts = []
        for i, m in enumerate(result):
            spec = matrix_spec(m, self._tolerance)
            div = f"vtpu-matrix-{i}"
            parts.append(
                f'<div id="{div}"></div>'
                f"<script>if (window.vegaEmbed) vegaEmbed('#{div}', "
                # '</' must not appear inside a <script> element (a token
                # containing '</script>' would terminate it -> HTML injection)
                f"{json.dumps(spec).replace('</', '<\\/')});</script>"
            )
        return "\n".join(parts)
