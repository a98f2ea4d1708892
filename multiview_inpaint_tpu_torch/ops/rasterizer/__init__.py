from .api import (RenderCamera, RenderOutput, render, render_oracle,
                  render_views)
from .composite import DEPTH_EMPTY
