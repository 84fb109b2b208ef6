"""Model registry of the port (counterpart of `tpu_tts/models/__init__.py`)."""


def setup_model(config, device=None):
    """Build the model a config names, on `device` (`cuda` by default)."""
    if config.model.lower() != "vits":
        raise NotImplementedError(f"model `{config.model}` is not ported yet (ROADMAP.md, queue 1)")
    from tpu_tts_torch.models.vits import Vits

    return Vits.init_from_config(config, device=device)
