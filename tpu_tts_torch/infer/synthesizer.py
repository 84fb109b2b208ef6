"""Synthesizer: checkpoint + config (+ vocoder) → text-to-speech on a device.

Counterpart of `tpu_tts/infer/synthesizer.py` (`Synthesizer`:19,
`_load_vocoder`:80, `save_wav`:137, `resolve_speaker`/`resolve_language`
:140-176, `tts`:176 with its Griffin-Lim switch :206, vocoder stage :241-254
and silence trim :255-256, `_interpolate_mel`:272). Checkpoints are `.pth`
files of the model's net beside its `config.json`: the port's own
`state_dict`, or a Coqui-format checkpoint (`BaseTTSModel.load_checkpoint`).
An end-to-end model (VITS) gives the waveform; a mel model (Glow-TTS) hands
its mel to the vocoder (WaveRNN) through the audio configs' denormalize →
normalize handshake, resampled in time when the two sample rates differ,
or, with no vocoder loaded, to Griffin-Lim on the host. Each sentence's
waveform is cut at `ap.find_endpoint` when the TTS audio config sets
`do_trim_silence`. Sentences are synthesised one by one and joined with
10000 samples of silence, as in the JAX synthesizer.

Where the port differs from the JAX synthesizer on purpose (ROADMAP.md,
queue 3): the vocoder's waveform is taken as the 1-D array WaveRNN returns
(the JAX synthesizer indexes it `[0, :, 0]` and so fails with WaveRNN); and
Griffin-Lim's first phases are drawn from the request's `seed`, so a
request is repeatable. Speaker and language managers come with
multi-speaker models (M5c); until then both are None and the resolvers
return no ids, as the JAX ones do for a model without managers.
"""

import time
from typing import List

import numpy as np

from tpu_tts_torch.config import load_config
from tpu_tts_torch.device import resolve_device
from tpu_tts_torch.infer.synthesis import synthesis, trim_silence
from tpu_tts_torch.text.sentence_split import split_sentences

SENTENCE_GAP = 10000  # samples of silence after each sentence


class Synthesizer:
    def __init__(self, tts_checkpoint: str = "", tts_config_path: str = "", vocoder_checkpoint: str = "",
                 vocoder_config: str = "", device=None, tts_speakers_file: str = "") -> None:
        """`device`: where the models run, `cuda` unless told otherwise;
        `tts_speakers_file` overrides the config's speakers file."""
        self.device = resolve_device(device)
        self.tts_checkpoint = tts_checkpoint
        self.tts_config_path = tts_config_path
        self.tts_speakers_file = tts_speakers_file
        self.vocoder_checkpoint = vocoder_checkpoint
        self.vocoder_config_path = vocoder_config
        self.tts_model = None
        self.tts_config = None
        self.vocoder_model = None
        self.vocoder_config = None
        self.speaker_manager = None
        self.language_manager = None
        self.output_sample_rate = 22050
        if tts_checkpoint:
            self._load_tts(tts_checkpoint, tts_config_path)
        if vocoder_checkpoint:
            self._load_vocoder(vocoder_checkpoint, vocoder_config)

    def _load_tts(self, checkpoint: str, config_path: str) -> None:
        from tpu_tts_torch.models import setup_model

        self.tts_config = load_config(config_path)
        if self.tts_speakers_file:
            # the CLI's and server's override of the config's speakers file
            if hasattr(self.tts_config, "speakers_file"):
                self.tts_config.speakers_file = self.tts_speakers_file
            if getattr(self.tts_config, "model_args", None) is not None and hasattr(
                self.tts_config.model_args, "speakers_file"
            ):
                self.tts_config.model_args.speakers_file = self.tts_speakers_file
        self.tts_model = setup_model(self.tts_config, device=self.device)
        self.tts_model.load_checkpoint(self.tts_config, checkpoint, eval=True)
        self.speaker_manager = self.tts_model.speaker_manager
        self.language_manager = self.tts_model.language_manager
        self.output_sample_rate = self.tts_config.audio["sample_rate"]

    def _load_vocoder(self, checkpoint: str, config_path: str) -> None:
        from tpu_tts_torch.audio import AudioProcessor
        from tpu_tts_torch.vocoder.models import setup_model as setup_vocoder

        self.vocoder_config = load_config(config_path)
        self.vocoder_ap = AudioProcessor.init_from_config(self.vocoder_config)
        self.vocoder_model = setup_vocoder(self.vocoder_config, device=self.device)
        self.vocoder_model.load_checkpoint(self.vocoder_config, checkpoint, eval=True)
        self.output_sample_rate = self.vocoder_config.audio["sample_rate"]

    def split_into_sentences(self, text: str) -> List[str]:
        return split_sentences(text)

    def save_wav(self, wav, path: str, pipe_out=None) -> None:
        self.tts_model.ap.save_wav(np.asarray(wav, dtype=np.float32), path, self.output_sample_rate,
                                   pipe_out=pipe_out)

    # --------------------------------------------------------- id resolution
    def resolve_speaker(self, speaker_name: str = "", speaker_wav=None):
        """(speaker_id, d_vector) of a request, shared by `tts` and the
        micro-batcher; (None, None) for a model without a speaker manager."""
        speaker_id = None
        d_vector = None
        if self.speaker_manager is not None and getattr(self.speaker_manager, "name_to_id", None):
            if speaker_name and isinstance(speaker_name, str):
                if getattr(self.tts_config, "use_d_vector_file", False) or (
                    hasattr(self.tts_config, "model_args")
                    and getattr(self.tts_config.model_args, "use_d_vector_file", False)
                ):
                    d_vector = self.speaker_manager.get_mean_embedding(speaker_name, num_samples=None)
                else:
                    speaker_id = self.speaker_manager.name_to_id[speaker_name]
            elif len(self.speaker_manager.name_to_id) == 1:
                speaker_id = list(self.speaker_manager.name_to_id.values())[0]
            elif not speaker_wav:
                if len(self.speaker_manager.name_to_id) > 1:
                    raise ValueError(
                        " [!] Looks like you are using a multi-speaker model. "
                        "You need to define either a `speaker_idx` or a `speaker_wav` to use a multi-speaker model."
                    )
        if speaker_wav is not None and self.speaker_manager is not None and self.speaker_manager.encoder is not None:
            d_vector = self.speaker_manager.compute_embedding_from_clip(speaker_wav)
        return speaker_id, d_vector

    def resolve_language(self, language_name: str = ""):
        """The language id of a request; None for a model without a language manager."""
        language_id = None
        if self.language_manager is not None and getattr(self.language_manager, "name_to_id", None):
            if language_name and isinstance(language_name, str):
                language_id = self.language_manager.name_to_id[language_name]
            elif len(self.language_manager.name_to_id) == 1:
                language_id = list(self.language_manager.name_to_id.values())[0]
        return language_id

    # ------------------------------------------------------------------- tts
    def vocode(self, mel: np.ndarray) -> np.ndarray:
        """A TTS model's normalised mel `[T, C]` → the vocoder's waveform."""
        mel_denorm = self.tts_model.ap.denormalize(mel.T).T
        vocoder_input = self.vocoder_ap.normalize(mel_denorm.T).T
        scale_factor = self.vocoder_config.audio["sample_rate"] / self.tts_config.audio["sample_rate"]
        if scale_factor != 1.0:
            vocoder_input = _interpolate_mel(vocoder_input, scale_factor)
        return self.vocoder_model.inference(vocoder_input.astype(np.float32))

    def tts(self, text: str = "", speaker_name: str = "", language_name: str = "", speaker_wav=None,
            style_wav=None, reference_wav=None, split_sentences: bool = True, seed: int = 0,
            **kwargs) -> List[float]:
        """The waveform of `text` as a list of float samples. `seed` seeds the
        model's noise and, for a mel model without a vocoder, Griffin-Lim."""
        if not text and not reference_wav:
            raise ValueError("You need to define either `text` or a `reference_wav` to use the Coqui TTS API.")
        if reference_wav is not None or style_wav is not None:
            raise NotImplementedError("voice transfer and style references are not ported yet (ROADMAP.md)")
        start = time.time()
        sens = self.split_into_sentences(text) if split_sentences else [text]
        speaker_id, d_vector = self.resolve_speaker(speaker_name, speaker_wav)
        language_id = self.resolve_language(language_name)
        use_gl = self.vocoder_model is None
        do_trim = bool(getattr(self.tts_config.audio, "do_trim_silence", False)) and self.tts_model.ap is not None
        wavs: List[float] = []
        for sen in sens:
            outputs = synthesis(self.tts_model, sen, self.tts_config, speaker_id=speaker_id, d_vector=d_vector,
                                language_id=language_id, use_griffin_lim=use_gl, do_trim_silence=False, seed=seed)
            wav = outputs["wav"] if outputs["wav"] is not None else self.vocode(outputs["model_outputs"])
            if do_trim:
                wav = trim_silence(wav, self.tts_model.ap)
            wavs += list(np.asarray(wav, dtype=np.float32))
            wavs += [0.0] * SENTENCE_GAP
        process_time = time.time() - start
        audio_time = len(wavs) / self.output_sample_rate
        print(f" > Processing time: {process_time}")
        print(f" > Real-time factor: {process_time / max(audio_time, 1e-9)}")
        return wavs


def _interpolate_mel(mel: np.ndarray, scale_factor: float) -> np.ndarray:
    """Linear interpolation of a mel `[T, C]` along time by `scale_factor`."""
    T, C = mel.shape
    new_T = int(round(T * scale_factor))
    x_old = np.linspace(0, 1, T)
    x_new = np.linspace(0, 1, new_T)
    return np.stack([np.interp(x_new, x_old, mel[:, c]) for c in range(C)], axis=1)
