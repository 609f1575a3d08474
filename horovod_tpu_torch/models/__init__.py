"""Models of the port, under the reference's export names."""

from horovod_tpu_torch.models.resnet import (  # noqa: F401
    Bottleneck,
    ResNet,
    ResNetConfig,
    init_params as init_resnet,
    params_from_jax as resnet_params_from_jax,
    resnet50,
    resnet101,
)
from horovod_tpu_torch.models.moe import (  # noqa: F401
    MoEConfig,
    make_moe_ffn,
    moe_ffn,
    moe_ffn_island,
)
from horovod_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    init_params as init_transformer,
    forward as transformer_forward,
    gather_params,
    lm_loss,
    make_train_step,
    params_from_jax,
    shard_batch,
    shard_params,
)
