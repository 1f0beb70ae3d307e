"""The LM stack of the port, dense GQA family (tinyllama-1.1b): blocks,
GQA attention with the flash kernel on the prompt pass, the layer-stacked
model and the conversion of the JAX package's weights."""

from repro_torch.models.model import Model, ModelConfig, build_model

__all__ = ["Model", "ModelConfig", "build_model"]
