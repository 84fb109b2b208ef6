"""Base of the port's TTS models: config, audio settings, tokenizer, device,
speaker/language managers and checkpoint loading (`utils/checkpoint.py`).

Counterpart of `tpu_tts/models/base_tts.py`, with `on_init_start`:84 and
`get_data_loader`:137 (with `_sampler_weights`:188) of its training
contract: the speaker and language maps of the managers go into the
collate, and the speaker, language and length balancers weight the
loader's draws. The rest of the contract (`init_training`,
`num_optimizers`, `optimizer_params`, `loss_fn`, `get_optimizer`) is the
model's own (`models/vits.py`).
"""

import os
from typing import Optional

import torch

from tpu_tts_torch.device import resolve_device
from tpu_tts_torch.utils.checkpoint import load_net_checkpoint


class BaseTTSModel:
    def __init__(self, config, ap=None, tokenizer=None, device: Optional[str] = None, speaker_manager=None,
                 language_manager=None):
        self.config = config
        self.ap = ap
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self.net: torch.nn.Module = None
        self.speaker_manager = speaker_manager
        self.language_manager = language_manager

    def load_checkpoint(self, config, checkpoint_path: str, eval: bool = True, strict: bool = True):
        """Load a `.pth` file into `self.net`: the port's `state_dict`, or a
        Coqui-format checkpoint (`{"model": ...}` or flat)."""
        ckpt = load_net_checkpoint(self.net, checkpoint_path, strict=strict)
        if eval:
            self.net.eval()
        return ckpt

    def on_init_start(self, trainer):
        """Write `speakers.pth` and `language_ids.json` beside the run's
        config and point the config at them, so the run directory serves."""
        for manager, name, keys in ((self.speaker_manager, "speakers.pth", ("speakers_file",)),
                                    (self.language_manager, "language_ids.json", ("language_ids_file",))):
            if manager is None or not manager.name_to_id:
                continue
            path = os.path.join(trainer.output_path, name)
            manager.save_ids_to_file(path)
            for cfg in (trainer.config, getattr(trainer.config, "model_args", None)):
                for key in keys:
                    if cfg is not None and cfg.has(key):
                        setattr(cfg, key, path)
            print(f" > `{name}` saved to {path}.", flush=True)

    def get_data_loader(self, config, assets, is_eval: bool, samples, verbose: bool, num_gpus: int = 1,
                        rank: int = 0):
        """A `TTSDataLoader` over `samples`, length-filtered and sorted, with
        the speaker, language and d-vector maps, the balancers' weights, and
        the pitch (`compute_f0`), energy (`compute_energy`) and aligner
        priors (`use_attn_priors`) a config asks for."""
        from tpu_tts_torch.data.dataset import TTSDataLoader, TTSDataset

        if num_gpus > 1:
            raise NotImplementedError("per-process data sharding comes with the data-parallel trainer (ROADMAP.md, M10)")
        if getattr(config, "compute_linear_spec", False):
            raise NotImplementedError("`compute_linear_spec` comes with the models that read it (ROADMAP.md, M9b)")
        dataset = TTSDataset(
            outputs_per_step=getattr(config, "r", 1),
            samples=samples,
            ap=self.ap,
            return_wav=getattr(config, "return_wav", False),
            compute_f0=getattr(config, "compute_f0", False),
            f0_cache_path=getattr(config, "f0_cache_path", None),
            compute_energy=getattr(config, "compute_energy", False),
            energy_cache_path=getattr(config, "energy_cache_path", None),
            use_attn_prior=getattr(config, "use_attn_priors", False),
            attn_prior_cache_path=getattr(config, "attn_prior_cache_path", None),
            batch_group_size=0 if is_eval else config.batch_group_size * config.batch_size,
            min_text_len=config.min_text_len,
            max_text_len=config.max_text_len,
            min_audio_len=config.min_audio_len,
            max_audio_len=config.max_audio_len,
            phoneme_cache_path=config.phoneme_cache_path,
            use_noise_augment=False if is_eval else config.use_noise_augment,
            tokenizer=self.tokenizer,
            start_by_longest=config.start_by_longest,
            verbose=verbose,
            speaker_id_mapping=self.speaker_manager.name_to_id if self.speaker_manager else None,
            d_vector_mapping=(self.speaker_manager.embeddings_by_names()
                              if self.speaker_manager and getattr(self.config, "use_d_vector_file", False) else None),
            language_id_mapping=self.language_manager.name_to_id if self.language_manager else None,
        )
        dataset.preprocess_samples()
        return TTSDataLoader(
            dataset,
            batch_size=config.eval_batch_size if is_eval else config.batch_size,
            shuffle=not is_eval and config.shuffle,
            drop_last=not is_eval,
            seed=getattr(config, "training_seed", 0),
            num_workers=getattr(config, "num_eval_loader_workers" if is_eval else "num_loader_workers", 0),
            weights=None if is_eval else sampler_weights(config, dataset.samples),
        )


def sampler_weights(config, samples):
    """The sum of the enabled balancers' weights (speaker, language, length),
    each times its alpha; None when none is enabled."""
    from tpu_tts_torch.managers import (
        get_language_balancer_weights,
        get_length_balancer_weights,
        get_speaker_balancer_weights,
    )

    weights = None
    for flag, fn, alpha in (("use_speaker_weighted_sampler", get_speaker_balancer_weights,
                             "speaker_weighted_sampler_alpha"),
                            ("use_language_weighted_sampler", get_language_balancer_weights,
                             "language_weighted_sampler_alpha"),
                            ("use_length_weighted_sampler", get_length_balancer_weights,
                             "length_weighted_sampler_alpha")):
        if getattr(config, flag, False):
            w = fn(samples) * getattr(config, alpha, 1.0)
            weights = w if weights is None else weights + w
    return weights
