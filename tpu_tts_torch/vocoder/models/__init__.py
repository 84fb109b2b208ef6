"""Vocoder registry of the port (counterpart of `tpu_tts/vocoder/models/__init__.py`)."""


def setup_model(config, device=None):
    """Build the vocoder a config names, on `device` (`cuda` by default).
    Only WaveRNN is ported; every other vocoder raises."""
    name = (config.model if "model" in config and config.model else config.generator_model).lower()
    if name != "wavernn":
        raise NotImplementedError(f"vocoder `{name}` is not ported yet (ROADMAP.md, queue 1, M8)")
    from tpu_tts_torch.vocoder.models.wavernn import Wavernn

    return Wavernn.init_from_config(config, device=device)
