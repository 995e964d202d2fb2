from cosa_tpu_torch.models.network import (  # noqa: F401
    CoSANetwork,
    build_model,
    require_cosa_interface,
)
from cosa_tpu_torch.models.vit import BACKBONES, ViTConfig, VisionTransformer  # noqa: F401
