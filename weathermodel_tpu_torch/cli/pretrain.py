"""Model construction and checkpoint loading shared by the entry points
(the ported subset of weathermodel_tpu/cli/pretrain.py: `make_model` for
the WeatherBERT family, `load_pretrained_params` for reference `.pth`
files). The training entry point itself is not ported yet."""

from weathermodel_tpu_torch.models.transfer import load_reference_checkpoint
from weathermodel_tpu_torch.models.weatherbert import (
    SimMTM,
    WeatherAutoencoder,
    WeatherBERT,
)
from weathermodel_tpu_torch.utils.config import ModelConfig

PORTED_MODELS = {
    "weatherbert": WeatherBERT,
    "weatherautoencoder": WeatherAutoencoder,
    "simmtm": SimMTM,
}
# models of the JAX package that the port does not have yet
UNPORTED_MODELS = ("weatherformer", "weatherformersinusoid",
                   "weatherformermixture", "mlp", "weathercnn")


def make_model(name: str, cfg: ModelConfig, attention_impl: str,
               ffn_impl: str = "torch", num_experts: int = 0):
    if name in UNPORTED_MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported yet; see ROADMAP.md queue A "
            "items 8 and 11")
    if name not in PORTED_MODELS:
        raise ValueError(f"Unknown model type: {name}. Choose one of "
                         + ", ".join((*PORTED_MODELS, *UNPORTED_MODELS)))
    return PORTED_MODELS[name](cfg, attention_impl=attention_impl,
                               ffn_impl=ffn_impl, num_experts=num_experts)


def load_pretrained_params(path: str) -> dict:
    """State dict of a reference torch checkpoint (.pth / .pt)."""
    if path.endswith((".pth", ".pt")):
        return load_reference_checkpoint(path)
    raise NotImplementedError(
        f"{path} is not a .pth/.pt file. Orbax checkpoint directories (the "
        "JAX trainer's output) cannot be read without JAX; see ROADMAP.md "
        "queue A item 16")
