"""GAN vocoders: a generator and a discriminator, served and trained.

Counterpart of `tpu_tts/vocoder/models/gan.py` (`GAN`:24: `__init__`:25
with PQMF :32-37, `handles_mixed_precision`:43, `convert_torch_state_dict`
:52, `_disc_apply_paired`:123, `loss_fn`:144, `get_optimizer`:184,
`inference`:202, `get_data_loader`:214). The net holds `model_g` and
`model_d`, Coqui's names, so a Coqui GAN `.pth` loads by key
(`vocoder_convert.py`); a generator-only checkpoint keeps the discriminator
the model was built with. A GAN built for serving (`discriminator=False`,
the `Synthesizer`'s) has no discriminator and reads none from a
checkpoint.

Inference (`eval()` mode): mel `[B, T, C]` or `[T, C]` → waveform
`[B, T·hop, 1]`, the generator applied to the mel as it is (`tpu_tts`'s
`GAN.inference` does not call the generator's edge-padding `inference`;
Coqui's does, ROADMAP.md, queue 3, F12), then PQMF synthesis for the
multi-band generator. HiFi-GAN's ResBlock1 stages go through K1
(`ops/hifigan_mrf.py`) on the card, where `tpu_tts` runs them in XLA
(divergence 5). UnivNet's noise comes from a `torch.Generator` seeded with
`seed` (`tpu_tts` cannot run it, queue 3).

Training (`loss_fn`, D = 0, G = 1): each sub-step runs its own generator
forward; the waveform is cut to the shorter of the real and generated
lengths. D sees the generated waveform detached, in one pass over [real;
fake]. G sees D frozen, the fake half with gradients and the real half
without (divergence 20: JAX makes one paired pass; the numbers are the
same). With PQMF the subband STFT term compares the generator's bands with
the analysis of the real waveform. `steps_to_start_discriminator` is read
by neither package: D trains from step 0 (queue 3, F11). The generator in
`train()` mode runs ResBlock1 in plain PyTorch: K1 has no backward.

Mixed precision: a HiFi-GAN generator and discriminator take a bfloat16
compute dtype (`conv_post` and the tanh stay float32), as the flax modules'
`dtype`; every other family goes through the trainer's generic cast of
`net`.
"""

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from tpu_tts_torch.device import resolve_device
from tpu_tts_torch.layers.common import frozen, set_compute_dtype
from tpu_tts_torch.layers.vits import paired_disc_apply
from tpu_tts_torch.utils.checkpoint import read_checkpoint
from tpu_tts_torch.vocoder.layers.losses import GeneratorLossConfig, discriminator_loss, generator_loss


class GanNet(nn.Module):
    def __init__(self, model_g: nn.Module, model_d: Optional[nn.Module]):
        super().__init__()
        self.model_g = model_g
        self.model_d = model_d


class GAN:
    def __init__(self, config, ap=None, device=None, discriminator: bool = True):
        from tpu_tts_torch.vocoder.models import setup_discriminator, setup_generator

        self.config = config
        self.ap = ap
        self.device = resolve_device(device)
        model_d = setup_discriminator(config) if discriminator else None
        self.net = GanNet(setup_generator(config), model_d).to(self.device).eval()
        self.gen_loss_cfg = GeneratorLossConfig(config)
        self.pqmf = None
        if getattr(config, "use_pqmf", False):
            from tpu_tts_torch.vocoder.layers.pqmf import PQMF

            self.pqmf = PQMF(N=4, taps=62, cutoff=0.15, beta=9.0)
        self.is_univnet = "univnet" in str(config.generator_model).lower()

    @property
    def model_g(self) -> nn.Module:
        return self.net.model_g

    @property
    def model_d(self) -> nn.Module:
        return self.net.model_d

    def handles_mixed_precision(self) -> bool:
        """A HiFi-GAN generator and discriminator take their own compute dtype."""
        gen = str(getattr(self.config, "generator_model", "")).lower()
        disc = str(getattr(self.config, "discriminator_model", "")).lower()
        return "hifigan" in gen and ("hifigan" in disc or not disc)

    # ------------------------------------------------------------ training
    def init_training(self):
        if getattr(self.config, "mixed_precision", False) and self.handles_mixed_precision():
            set_compute_dtype(self.net, torch.bfloat16)
            self.model_g.conv_post.compute_dtype = None  # conv_post and the tanh stay float32

    def num_optimizers(self) -> int:
        return 2

    def optimizer_params(self, optimizer_idx: int):
        """The parameters optimizer `optimizer_idx` trains: D = 0, G = 1."""
        return list((self.model_d if optimizer_idx == 0 else self.model_g).parameters())

    def train(self, mode: bool = True):
        self.net.train(mode)

    def training_state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.net.state_dict())

    def load_training_state(self, state: Dict[str, torch.Tensor], strict: bool = True):
        """Load a state dict: the port's `training_state_dict` or a Coqui
        GAN's (`vocoder_convert.coqui_gan_state_dict`). The generator's keys
        load as `strict` says; the discriminator's only from a state that
        holds every one of them, else the model keeps its own, as the JAX
        package keeps a fresh discriminator for a generator-only checkpoint."""
        from tpu_tts_torch.vocoder.models.vocoder_convert import coqui_gan_state_dict

        sd = coqui_gan_state_dict(state, set(self.net.state_dict()))
        parts = {part: {k[len(part) + 1:]: v for k, v in sd.items() if k.startswith(part + ".")}
                 for part in ("model_g", "model_d")}
        if not parts["model_g"]:
            raise ValueError(f"no generator weights among {len(state)} tensors: not a GAN vocoder state dict?")
        self.model_g.load_state_dict(parts["model_g"], strict=strict)
        if self.model_d is None:
            return
        if set(self.model_d.state_dict()) <= set(parts["model_d"]):
            self.model_d.load_state_dict(parts["model_d"], strict=strict)
        else:
            print(" > the checkpoint holds no discriminator of this model's layout; keeping the model's own")

    def load_checkpoint(self, config, checkpoint_path: str, eval: bool = True, strict: bool = True):
        """A Coqui GAN vocoder `.pth` (`{"model": ...}` or flat, with or
        without `model_d.*`) or the port's own (`load_training_state`)."""
        ckpt = read_checkpoint(checkpoint_path)
        self.load_training_state(ckpt["model"] if isinstance(ckpt.get("model"), dict) else ckpt, strict=strict)
        if eval:
            self.net.eval()
        return ckpt

    def generate(self, mel: torch.Tensor, generator: Optional[torch.Generator] = None):
        """mel `[B, C, T]` → (the generator's output, the waveform `[B, 1, T·hop]`):
        for a multi-band generator its bands and their PQMF synthesis."""
        y = self.model_g(mel, generator=generator) if self.is_univnet else self.model_g(mel)
        return y, (self.pqmf.synthesis(y) if self.pqmf is not None else y)

    def loss_fn(self, batch: Dict, optimizer_idx: int, generator: Optional[torch.Generator] = None):
        """(loss, logs) of the discriminator's (0) or the generator's (1)
        sub-step. batch: `mel_input` `[B, T_mel, C]`, `waveform` `[B, T, 1]`."""
        mel = batch["mel_input"].transpose(1, 2)
        y_real = batch["waveform"].transpose(1, 2)
        if optimizer_idx == 0:
            with torch.no_grad():
                _, y_hat = self.generate(mel, generator)
            T = min(y_hat.shape[2], y_real.shape[2])
            scores_real, scores_fake, _, _ = paired_disc_apply(self.model_d, y_real[:, :, :T], y_hat[:, :, :T])
            losses = discriminator_loss(self.config, scores_fake, scores_real)
            return losses["loss"], losses
        y_bands, y_hat = self.generate(mel, generator)
        T = min(y_hat.shape[2], y_real.shape[2])
        y_hat, y_real = y_hat[:, :, :T], y_real[:, :, :T]
        with frozen(self.model_d):
            scores_fake, feats_fake = self.model_d(y_hat)
            with torch.no_grad():
                _, feats_real = self.model_d(y_real)
        losses = generator_loss(self.gen_loss_cfg, y_hat=y_hat, y=y_real, scores_fake=scores_fake,
                                feats_fake=feats_fake, feats_real=feats_real,
                                y_hat_sub=y_bands if self.pqmf is not None else None,
                                y_sub=self.pqmf.analysis(y_real) if self.pqmf is not None else None)
        losses = {k: v if isinstance(v, torch.Tensor) else torch.tensor(float(v), device=y_hat.device)
                  for k, v in losses.items()}
        return losses["loss"], losses

    def get_optimizer(self):
        """[D, G] optimizers (`train/optimizers.py`), each with its own lr
        schedule and its entry of `grad_clip`."""
        from tpu_tts_torch.train.optimizers import get_optimizer, get_scheduler

        c = self.config
        scheds = (get_scheduler(getattr(c, "lr_scheduler_disc", None), getattr(c, "lr_scheduler_disc_params", {}) or {},
                                getattr(c, "lr_disc", c.lr)),
                  get_scheduler(getattr(c, "lr_scheduler_gen", None), getattr(c, "lr_scheduler_gen_params", {}) or {},
                                getattr(c, "lr_gen", c.lr)))
        return [get_optimizer(c.optimizer, c.optimizer_params, self.optimizer_params(i), c, schedule=scheds[i],
                              optimizer_idx=i) for i in range(2)]

    # ----------------------------------------------------------- inference
    @torch.no_grad()
    def inference(self, mel, seed: int = 0) -> np.ndarray:
        """mel `[B, T, C]` or `[T, C]` (numpy or tensor), normalised as the
        vocoder's audio config says → float32 waveform `[B, T·hop, 1]`."""
        mel = mel if isinstance(mel, torch.Tensor) else torch.from_numpy(np.asarray(mel, dtype=np.float32))
        mel = mel[None] if mel.dim() == 2 else mel
        gen = torch.Generator(device=self.device).manual_seed(int(seed)) if self.is_univnet else None
        _, y = self.generate(mel.to(device=self.device, dtype=torch.float32).transpose(1, 2), gen)
        return y.transpose(1, 2).float().cpu().numpy()

    # ---------------------------------------------------------- dataloader
    def get_data_loader(self, config, assets, is_eval, samples, verbose, num_gpus=1, rank=0):
        from tpu_tts_torch.vocoder.datasets import setup_dataset
        from tpu_tts_torch.vocoder.datasets.gan_dataset import GANDataLoader

        seed = getattr(config, "training_seed", 0) or 0
        dataset = setup_dataset(config, self.ap, is_eval, samples, verbose, seed=seed)
        return GANDataLoader(dataset, batch_size=config.eval_batch_size if is_eval else config.batch_size,
                             shuffle=not is_eval, drop_last=not is_eval, seed=seed,
                             num_workers=getattr(config, "num_eval_loader_workers" if is_eval else "num_loader_workers",
                                                 0))

    @staticmethod
    def init_from_config(config, device=None, samples=None, discriminator: bool = True):
        from tpu_tts_torch.audio import AudioProcessor

        return GAN(config, ap=AudioProcessor.init_from_config(config), device=device, discriminator=discriminator)
