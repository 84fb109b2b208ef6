"""Vocoder registry of the port (counterpart of `tpu_tts/vocoder/models/__init__.py`:
`setup_model`:13, `setup_generator`:31, `setup_discriminator`:105)."""


def setup_model(config, device=None, discriminator: bool = True):
    """Build the vocoder a config names, on `device` (`cuda` by default): a
    `GAN` when the config names a discriminator, else WaveRNN. Without
    `discriminator` a GAN is built for serving, its generator alone."""
    if "discriminator_model" in config and config.discriminator_model:
        from tpu_tts_torch.vocoder.models.gan import GAN

        return GAN.init_from_config(config, device=device, discriminator=discriminator)
    name = (config.model if "model" in config and config.model else config.generator_model).lower()
    if name != "wavernn":
        item = "WaveGrad" if name == "wavegrad" else name
        raise NotImplementedError(f"vocoder `{name}` is not ported yet (ROADMAP.md, queue 1, M8: {item})")
    from tpu_tts_torch.vocoder.models.wavernn import Wavernn

    return Wavernn.init_from_config(config, device=device)


def setup_generator(c):
    """The generator module a GAN config names (channels-first)."""
    base = c.generator_model.lower().replace("_generator", "")
    p = dict(c.generator_model_params or {})
    if base == "hifigan":
        from tpu_tts_torch.vocoder.models.hifigan_generator import HifiganGenerator

        return HifiganGenerator(in_channels=c.audio.num_mels, out_channels=1, **p)
    if base in ("melgan", "fullband_melgan"):
        from tpu_tts_torch.vocoder.models.melgan_generator import MelganGenerator

        return MelganGenerator(in_channels=c.audio.num_mels, out_channels=1,
                               upsample_factors=tuple(p.get("upsample_factors", (8, 8, 2, 2))),
                               num_res_blocks=p.get("num_res_blocks", 3))
    if base == "multiband_melgan":
        from tpu_tts_torch.vocoder.models.melgan_generator import multiband_melgan_generator

        return multiband_melgan_generator(c.audio.num_mels, tuple(p.get("upsample_factors", (2, 8, 2, 2))),
                                          p.get("num_res_blocks", 4))
    if base == "univnet":
        from tpu_tts_torch.vocoder.models.univnet_generator import UnivnetGenerator

        return UnivnetGenerator(in_channels=p.get("in_channels", 64), out_channels=p.get("out_channels", 1),
                                hidden_channels=p.get("hidden_channels", 32), cond_channels=c.audio.num_mels,
                                upsample_factors=tuple(p.get("upsample_factors", (8, 8, 4))),
                                lvc_layers_each_block=p.get("lvc_layers_each_block", 4),
                                lvc_kernel_size=p.get("lvc_kernel_size", 3),
                                kpnet_hidden_channels=p.get("kpnet_hidden_channels", 64),
                                kpnet_conv_size=p.get("kpnet_conv_size", 3))
    if base == "parallel_wavegan":
        raise NotImplementedError("the Parallel WaveGAN generator is not ported yet (ROADMAP.md, queue 1, M8)")
    raise NotImplementedError(f" [!] Generator model {c.generator_model} is not implemented.")


def setup_discriminator(c):
    """The discriminator module a GAN config names."""
    base = c.discriminator_model.lower().replace("_discriminator", "")
    if base == "hifigan":
        from tpu_tts_torch.vocoder.models.hifigan_discriminator import HifiganDiscriminator

        return HifiganDiscriminator()
    if base == "melgan_multiscale":
        from tpu_tts_torch.vocoder.models.melgan_discriminator import MelganMultiscaleDiscriminator

        p = c.discriminator_model_params or {}
        return MelganMultiscaleDiscriminator(base_channels=p.get("base_channels", 16),
                                             max_channels=p.get("max_channels", 1024),
                                             downsample_factors=tuple(p.get("downsample_factors", (4, 4, 4))))
    if base == "univnet":
        from tpu_tts_torch.vocoder.models.univnet_discriminator import UnivnetDiscriminator

        return UnivnetDiscriminator()
    if base in ("parallel_wavegan", "random_window"):
        raise NotImplementedError(f"the {c.discriminator_model} discriminator is not ported yet (ROADMAP.md, queue 1, "
                                  "M8: Parallel WaveGAN and the random-window discriminator)")
    raise NotImplementedError(f" [!] Discriminator model {c.discriminator_model} is not implemented.")
