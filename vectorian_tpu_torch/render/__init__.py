from vectorian_tpu_torch.render.excerpt import ExcerptRenderer  # noqa: F401
from vectorian_tpu_torch.render.location import Location, LocationFormatter  # noqa: F401
from vectorian_tpu_torch.render.matrix import MatrixRenderer, matrix_spec  # noqa: F401
from vectorian_tpu_torch.render.render import Renderer  # noqa: F401
from vectorian_tpu_torch.render.sankey import FlowRenderer  # noqa: F401
from vectorian_tpu_torch.render.utils import flow_edges  # noqa: F401
