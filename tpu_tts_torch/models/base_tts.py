"""Base of the port's TTS models: config, audio settings, tokenizer, device,
speaker/language managers and checkpoint loading (`utils/checkpoint.py`).

Counterpart of `tpu_tts/models/base_tts.py`, with `get_data_loader`:137 of
its training contract; the rest of the contract (`init_training`,
`num_optimizers`, `optimizer_params`, `loss_fn`, `get_optimizer`) is the
model's own (`models/vits.py`). The weighted samplers (speaker, language,
length balancing) are not ported yet (ROADMAP.md, M6).
"""

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

    def get_data_loader(self, config, assets, is_eval: bool, samples, verbose: bool, num_gpus: int = 1,
                        rank: int = 0):
        """A `TTSDataLoader` over `samples`, length-filtered and sorted."""
        from tpu_tts_torch.data.dataset import TTSDataLoader, TTSDataset

        if num_gpus > 1:
            raise NotImplementedError("per-process data sharding comes with the data-parallel trainer (ROADMAP.md, M10)")
        for key in ("use_speaker_weighted_sampler", "use_language_weighted_sampler", "use_length_weighted_sampler"):
            if not is_eval and getattr(config, key, False):
                raise NotImplementedError(f"`{key}` is not ported yet (ROADMAP.md, M6)")
        for key in ("compute_linear_spec", "compute_f0", "compute_energy", "use_attn_priors"):
            if getattr(config, key, False):
                raise NotImplementedError(f"`{key}` comes with the models that read it (ROADMAP.md, M9)")
        dataset = TTSDataset(
            outputs_per_step=getattr(config, "r", 1),
            samples=samples,
            ap=self.ap,
            return_wav=getattr(config, "return_wav", False),
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
        )
        dataset.preprocess_samples()
        return TTSDataLoader(
            dataset,
            batch_size=config.eval_batch_size if is_eval else config.batch_size,
            shuffle=not is_eval and config.shuffle,
            drop_last=not is_eval,
            seed=getattr(config, "training_seed", 0),
            num_workers=getattr(config, "num_eval_loader_workers" if is_eval else "num_loader_workers", 0),
        )
