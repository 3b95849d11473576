"""Top-level HTML renderer.

Reference: vectorian/render/render.py — bulma-styled HTML embedded in a
srcdoc iframe with resize JS (:131-174) so notebook output is isolated.
"""

from __future__ import annotations

import html as html_mod
import uuid

BULMA = "https://cdn.jsdelivr.net/npm/bulma@0.9.3/css/bulma.min.css"

_RESIZE_JS = """
<script>
function vtpu_resize(el) {
  try {
    el.style.height = (el.contentWindow.document.body.scrollHeight + 32) + 'px';
  } catch (e) {}
}
</script>
"""


class Renderer:
    """Combines one or more sub-renderers into notebook-ready HTML."""

    def __init__(self, renderers=None, location_formatter=None):
        from vectorian_tpu_torch.render.excerpt import ExcerptRenderer
        from vectorian_tpu_torch.render.location import LocationFormatter

        self._renderers = renderers if renderers is not None else [ExcerptRenderer()]
        self._location_formatter = location_formatter or LocationFormatter()

    def to_html(self, result) -> str:
        body = "\n".join(r.to_html(result) for r in self._renderers)
        page = (
            f'<!DOCTYPE html><html><head><meta charset="utf-8">'
            f'<link rel="stylesheet" href="{BULMA}"></head>'
            f'<body style="margin:1em;">{body}</body></html>'
        )
        frame_id = f"vtpu-{uuid.uuid4().hex[:8]}"
        return (
            _RESIZE_JS
            + f'<iframe id="{frame_id}" srcdoc="{html_mod.escape(page)}" '
            f'style="width:100%;border:none;" onload="vtpu_resize(this)"></iframe>'
        )

    def _repr_html_(self):  # pragma: no cover
        return self.to_html([])
