"""Python user API of the port: `from tpu_tts_torch.api import TTS`.

Counterpart of `tpu_tts/api.py` (`TTS`:13, `list_models`:50,
`is_multi_speaker`/`speakers`/`is_multi_lingual`/`languages`:61-79,
`load_tts_model_by_path`:123, `tts`:139, `tts_to_file`:145) for models
given by local path. Loading a released model by name needs a download
and raises (ROADMAP.md); so does voice conversion, which comes with its
models.

Example:
    >>> tts = TTS(model_path="model.pth", config_path="config.json", device="cpu")
    >>> tts.tts_to_file(text="Hello world!", file_path="out.wav")
"""

from typing import List


class TTS:
    def __init__(self, model_name: str = "", model_path: str = None, config_path: str = None,
                 vocoder_path: str = None, vocoder_config_path: str = None, progress_bar: bool = True,
                 gpu: bool = False, device=None):
        """`device`: where the models run, `cuda` unless told otherwise; `gpu`
        is accepted for the JAX package's callers."""
        from tpu_tts_torch.zoo.manage import ModelManager

        self.manager = ModelManager(verbose=False, progress_bar=progress_bar)
        self.synthesizer = None
        self.model_name = model_name
        self.device = device
        if model_name:
            self.load_tts_model_by_name(model_name)
        elif model_path:
            self.load_tts_model_by_path(model_path, config_path, vocoder_path, vocoder_config_path)

    @property
    def models(self) -> List[str]:
        return self.manager.list_tts_models()

    @staticmethod
    def list_models() -> List[str]:
        from tpu_tts_torch.zoo.manage import ModelManager

        return ModelManager(verbose=False).list_models()

    @property
    def is_multi_speaker(self) -> bool:
        sm = self.synthesizer.tts_model.speaker_manager if self.synthesizer and self.synthesizer.tts_model else None
        return bool(sm and sm.num_speakers > 1)

    @property
    def speakers(self):
        return self.synthesizer.tts_model.speaker_manager.speaker_names if self.is_multi_speaker else None

    @property
    def is_multi_lingual(self) -> bool:
        lm = self.synthesizer.tts_model.language_manager if self.synthesizer and self.synthesizer.tts_model else None
        return bool(lm and lm.num_languages > 1)

    @property
    def languages(self):
        return self.synthesizer.tts_model.language_manager.language_names if self.is_multi_lingual else None

    def load_tts_model_by_name(self, model_name: str):
        self.manager.download_model(model_name)  # raises: loading by name needs a download

    def load_tts_model_by_path(self, model_path, config_path, vocoder_path=None, vocoder_config_path=None):
        from tpu_tts_torch.infer.synthesizer import Synthesizer

        self.synthesizer = Synthesizer(
            tts_checkpoint=model_path,
            tts_config_path=config_path,
            vocoder_checkpoint=vocoder_path or "",
            vocoder_config=vocoder_config_path or "",
            device=self.device,
        )

    def _check_arguments(self, speaker=None, language=None, speaker_wav=None, **kwargs):
        if self.is_multi_speaker and (speaker is None and speaker_wav is None):
            raise ValueError("Model is multi-speaker but no `speaker` is provided.")
        if self.is_multi_lingual and language is None:
            raise ValueError("Model is multi-lingual but no `language` is provided.")

    def tts(self, text: str, speaker: str = None, language: str = None, speaker_wav: str = None, **kwargs):
        self._check_arguments(speaker=speaker, language=language, speaker_wav=speaker_wav)
        return self.synthesizer.tts(
            text=text, speaker_name=speaker or "", language_name=language or "", speaker_wav=speaker_wav, **kwargs
        )

    def tts_to_file(self, text: str, speaker: str = None, language: str = None, speaker_wav: str = None,
                    file_path: str = "output.wav", pipe_out=None, **kwargs) -> str:
        wav = self.tts(text=text, speaker=speaker, language=language, speaker_wav=speaker_wav, **kwargs)
        self.synthesizer.save_wav(wav=wav, path=file_path, pipe_out=pipe_out)
        return file_path
