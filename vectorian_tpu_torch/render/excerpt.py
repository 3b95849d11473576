"""Excerpt renderer: per-match annotated text HTML.

Reference: vectorian/render/excerpt.py — matched tokens in bold with the
aligned query token and a similarity percentage tag; gap/context text
greyed; optional POS/metric/penalty annotations.  yattag is replaced with
plain string building."""

from __future__ import annotations

import html
import math


def score_color_class(score: float) -> str:
    # (reference excerpt.py:5-10)
    if score <= 0.25:
        return "tag is-danger"
    elif score <= 0.75:
        return "tag is-warning"
    return "tag is-success"


def _esc(s: str) -> str:
    return "&crarr;".join(html.escape(x) for x in s.split("\n"))


class ExcerptRenderer:
    def __init__(self, *annotate, context_size: int = 10):
        self._annotate = {x: True for x in annotate}
        self._context_size = context_size

    @property
    def name(self):
        return "excerpt"

    def _match_region_html(self, region) -> str:
        parts = ['<span style="display:inline-table;vertical-align:top;">']
        parts.append('<span style="display:table-row;">')
        parts.append(
            '<span style="display:table-cell;">'
            f'<span class="has-text-black has-text-weight-bold">{_esc(region["s"])}</span>'
            "&nbsp;</span>"
        )
        edge = region["edges"][0] if region["edges"] else None
        if edge is not None:
            parts.append(
                '<span style="display:table-cell;">'
                f'<span class="tag is-light">{html.escape(edge["t"]["text"])}</span>'
                "&nbsp;</span>"
            )
            similarity = 1.0 - edge["distance"]
            opacity = 0.5 + 0.5 * edge["flow"]
            pct = int(math.floor(100 * max(similarity, 0.0)))
            parts.append(
                f'<span style="display:table-cell;opacity:{opacity:.2f};">'
                f'<span class="{score_color_class(similarity)}">{pct}%</span></span>'
            )
            if self._annotate.get("tags"):
                parts.append(
                    '<span style="display:table-cell;">'
                    f'<span class="tag">{html.escape(edge["t"].get("pos", ""))}</span></span>'
                )
            if self._annotate.get("metric"):
                parts.append(
                    '<span style="display:table-cell;">'
                    f'<span class="tag is-info is-light">{html.escape(str(edge.get("metric", "")))}</span></span>'
                )
        parts.append("</span></span> ")
        return "".join(parts)

    def render_match(self, match_json: dict, doc_title: str = "") -> str:
        out = ["<div class='box'>"]
        score_pct = int(math.floor(100 * max(min(match_json["score"], 1.0), 0.0)))
        out.append(
            "<div class='level is-mobile' style='margin-bottom:0.4em;'>"
            f"<div class='level-left'><span class='{score_color_class(match_json['score'])}'>"
            f"{score_pct}%</span>&nbsp;"
            f"<span class='has-text-weight-semibold'>{html.escape(doc_title)}</span></div>"
            "</div>"
        )
        out.append("<p>")
        for region in match_json["regions"]:
            if "edges" in region:
                out.append(self._match_region_html(region))
            else:
                penalty = region.get("gap_penalty", 0.0)
                if self._annotate.get("penalties") and penalty > 0:
                    out.append(
                        f'<span class="tag is-light is-warning">-{penalty:.2f}</span>'
                    )
                out.append(
                    f'<span class="has-text-grey-light">{_esc(region["s"])}</span> '
                )
        out.append("</p>")
        omitted = match_json.get("omitted") or []
        if omitted:
            out.append(
                "<p class='is-size-7 has-text-grey'>omitted: "
                + ", ".join(html.escape(o) for o in omitted)
                + "</p>"
            )
        out.append("</div>")
        return "".join(out)

    def to_html(self, result) -> str:
        parts = []
        for m in result:
            parts.append(
                self.render_match(
                    m.to_json(self._context_size), getattr(m.doc, "title", "")
                )
            )
        return "\n".join(parts)
