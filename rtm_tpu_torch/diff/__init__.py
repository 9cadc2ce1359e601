from .inverse import (InverseRenderConfig, inverse_render, loss_and_grad,
                      render_loss)
from .params import (SceneParams, apply_params, extract_params,
                     scene_params_from_numpy)
