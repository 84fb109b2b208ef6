"""Model registry of the port (counterpart of `tpu_tts/models/__init__.py`)."""


def setup_model(config, device=None, samples=None):
    """Build the model a config names, on `device` (`cuda` by default);
    `samples` (training's) give a multi-speaker model its speaker ids. A
    config's `base_model` names the model class (`fast_pitch`,
    `fast_speech`, `fastspeech2`, `speedy_speech` → `forward_tts`)."""
    name = (getattr(config, "base_model", None) or config.model).lower()
    if name == "vits":
        from tpu_tts_torch.models.vits import Vits

        return Vits.init_from_config(config, device=device, samples=samples)
    if name == "glow_tts":
        from tpu_tts_torch.models.glow_tts import GlowTTS

        return GlowTTS.init_from_config(config, device=device)
    if name == "delightful_tts":
        from tpu_tts_torch.models.delightful_tts import DelightfulTTS

        return DelightfulTTS.init_from_config(config, device=device, samples=samples)
    if name == "forward_tts":
        from tpu_tts_torch.models.forward_tts import ForwardTTS

        return ForwardTTS.init_from_config(config, device=device, samples=samples)
    if name == "xtts":
        from tpu_tts_torch.models.xtts import Xtts

        return Xtts.init_from_config(config, device=device)
    raise NotImplementedError(f"model `{config.model}` is not ported yet (ROADMAP.md, queue 1)")
