"""Models of the port, under the reference's export names."""

from horovod_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    init_params as init_transformer,
    forward as transformer_forward,
    lm_loss,
    make_train_step,
    params_from_jax,
    shard_batch,
)
