"""Synthesizer: checkpoint + config (+ vocoder) → text-to-speech on a device.

Counterpart of `tpu_tts/infer/synthesizer.py` (`Synthesizer`:19,
`_load_vocoder`:80, `save_wav`:137, `resolve_speaker`/`resolve_language`
:140-176, `tts`:176 with its Griffin-Lim switch :206, vocoder stage :241-254
and silence trim :255-256, `_interpolate_mel`:272). Checkpoints are `.pth`
files of the model's net beside its `config.json`: the port's own
`state_dict`, or a Coqui-format checkpoint (`BaseTTSModel.load_checkpoint`).
An end-to-end model (VITS) gives the waveform; a mel model (Glow-TTS) hands
its mel to the vocoder (WaveRNN or a GAN vocoder) through the audio configs' denormalize →
normalize handshake, resampled in time when the two sample rates differ,
or, with no vocoder loaded, to Griffin-Lim on the host. Each sentence's
waveform is cut at `ap.find_endpoint` when the TTS audio config sets
`do_trim_silence`. Sentences are synthesised one by one and joined with
10000 samples of silence, as in the JAX synthesizer.

Where the port differs from the JAX synthesizer on purpose (ROADMAP.md,
queue 3): the vocoder's waveform is taken as the 1-D array WaveRNN returns
(the JAX synthesizer indexes it `[0, :, 0]` and so fails with WaveRNN; a
GAN vocoder's `[1, T, 1]` is indexed so in both); and
Griffin-Lim's first phases are drawn from the request's `seed`, so a
request is repeatable.

The speaker and language managers are the model's (`tpu_tts_torch/
managers.py`): a speaker name resolves to its id in the model's embedding
table, or with d-vectors to the mean of its clips' d-vectors; a language
name to its id. A model without managers resolves no ids, as in JAX. A
`speaker_wav` (a path or a list of them) gives the d-vector through the
speaker manager's encoder, attached as in JAX only by
`SpeakerManager(encoder_model_path=...)` or `init_encoder`; without one it
raises (ROADMAP.md, queue 3). With `reference_wav` the call is VITS voice conversion
(`tpu_tts/infer/synthesizer.py`:208-220): the reference speaker's name
resolves like the target's (a d-vector model takes that speaker's mean
d-vector, where JAX passes none), and the waveform is trimmed when
`do_trim_silence` is set (JAX's voice-conversion route never trims).

A model with its own pipeline (XTTS) gets each sentence through its
`synthesize` (`tpu_tts/infer/synthesizer.py`:223-231), with the speaker
name (a bundled speaker), `speaker_wav` and the language. `model_dir`
loads a model directory: `config.json`, a checkpoint (`model.pth`,
`model_file.pth`, `checkpoint.pth` or the first `.pth`) and the model's
own files, such as `speakers_xtts.pth` (`_load_tts_from_dir`,
`tpu_tts/infer/synthesizer.py`:102). The output rate is the model's
`output_sample_rate` where it has one (XTTS: 24 kHz), else the audio
config's.
"""

import glob
import os
import time
from typing import List

import numpy as np

from tpu_tts_torch.config import load_config
from tpu_tts_torch.device import resolve_device
from tpu_tts_torch.infer.synthesis import synthesis, transfer_voice, trim_silence
from tpu_tts_torch.text.sentence_split import split_sentences

SENTENCE_GAP = 10000  # samples of silence after each sentence


class Synthesizer:
    def __init__(self, tts_checkpoint: str = "", tts_config_path: str = "", vocoder_checkpoint: str = "",
                 vocoder_config: str = "", device=None, tts_speakers_file: str = "", model_dir: str = "") -> None:
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
        if model_dir:
            self._load_tts_from_dir(model_dir)

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
        self._after_tts_load()

    def _after_tts_load(self) -> None:
        self.speaker_manager = self.tts_model.speaker_manager
        self.language_manager = self.tts_model.language_manager
        rate = getattr(self.tts_model, "output_sample_rate", None)
        self.output_sample_rate = rate or self.tts_config.audio["sample_rate"]

    def _load_tts_from_dir(self, model_dir: str) -> None:
        """A model directory with its own `config.json` (XTTS releases)."""
        from tpu_tts_torch.models import setup_model

        self.tts_config = load_config(os.path.join(model_dir, "config.json"))
        if hasattr(self.tts_config, "model_dir"):
            self.tts_config.model_dir = model_dir
        self.tts_model = setup_model(self.tts_config, device=self.device)
        names = [p for p in ("model.pth", "model_file.pth", "checkpoint.pth")
                 if os.path.exists(os.path.join(model_dir, p))] or sorted(
            os.path.basename(p) for p in glob.glob(os.path.join(model_dir, "*.pth")))
        if not names:
            raise FileNotFoundError(f"no .pth checkpoint in {model_dir}")
        self.tts_model.load_checkpoint(self.tts_config, os.path.join(model_dir, names[0]), eval=True)
        self._after_tts_load()

    def _load_vocoder(self, checkpoint: str, config_path: str) -> None:
        from tpu_tts_torch.audio import AudioProcessor
        from tpu_tts_torch.vocoder.models import setup_model as setup_vocoder

        self.vocoder_config = load_config(config_path)
        self.vocoder_ap = AudioProcessor.init_from_config(self.vocoder_config)
        self.vocoder_model = setup_vocoder(self.vocoder_config, device=self.device, discriminator=False)
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
        micro-batcher; (None, None) for a model without a speaker manager.
        A `speaker_wav` gives the d-vector when the speaker manager has an
        encoder (`tpu_tts/infer/synthesizer.py`:162-163); without one the
        port raises where JAX ignores it (ROADMAP.md, queue 3)."""
        if speaker_wav and getattr(self.speaker_manager, "encoder", None) is None:
            raise NotImplementedError("a d-vector from `speaker_wav` needs a speaker encoder: attach one with "
                                      "`speaker_manager.init_encoder(model_path, config_path)`")
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
        if speaker_wav:
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
        wav = self.vocoder_model.inference(vocoder_input.astype(np.float32))
        return wav[0, :, 0] if wav.ndim == 3 else wav  # a GAN's [1, T, 1], as JAX indexes it; WaveRNN's 1-D

    def tts(self, text: str = "", speaker_name: str = "", language_name: str = "", speaker_wav=None,
            style_wav=None, reference_wav=None, reference_speaker_name: str = None, split_sentences: bool = True,
            seed: int = 0, **kwargs) -> List[float]:
        """The waveform of `text` as a list of float samples. `seed` seeds the
        model's noise and, for a mel model without a vocoder, Griffin-Lim.
        With `reference_wav` (a path or samples) it is voice conversion
        instead: that speech, spoken by `reference_speaker_name`, in the voice
        of `speaker_name` (VITS with a posterior encoder)."""
        if not text and not reference_wav:
            raise ValueError("You need to define either `text` or a `reference_wav` to use the Coqui TTS API.")
        if reference_wav is not None:
            return self.transfer_voice(reference_wav, speaker_name, reference_speaker_name, speaker_wav, seed)
        if style_wav is not None:
            raise NotImplementedError("style references come with the models that read them (ROADMAP.md, M9b)")
        start = time.time()
        sens = self.split_into_sentences(text) if split_sentences else [text]
        if hasattr(self.tts_model, "synthesize"):
            wavs = []
            for sen in sens:
                outputs = self.tts_model.synthesize(text=sen, config=self.tts_config,
                                                    speaker_id=speaker_name or "random", speaker_wav=speaker_wav,
                                                    language=language_name or "en", seed=seed, **kwargs)
                wavs += list(np.asarray(outputs["wav"], dtype=np.float32)) + [0.0] * SENTENCE_GAP
            self._report(start, wavs)
            return wavs
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
        self._report(start, wavs)
        return wavs

    def transfer_voice(self, reference_wav, speaker_name: str = "", reference_speaker_name: str = None,
                       speaker_wav=None, seed: int = 0) -> List[float]:
        """Voice conversion of `reference_wav` from `reference_speaker_name`'s
        voice (an id of the speaker table, or that speaker's mean d-vector)
        into `speaker_name`'s; trimmed as `do_trim_silence` says."""
        start = time.time()
        speaker_id, d_vector = self.resolve_speaker(speaker_name, speaker_wav)
        ref_id, ref_d_vector = None, None
        if reference_speaker_name and self.speaker_manager is not None:
            if getattr(self.tts_config, "use_d_vector_file", False):
                ref_d_vector = self.speaker_manager.get_mean_embedding(reference_speaker_name, num_samples=None)
            else:
                ref_id = self.speaker_manager.name_to_id.get(reference_speaker_name)
        ref = self.tts_model.ap.load_wav(reference_wav) if isinstance(reference_wav, str) else reference_wav
        do_trim = bool(getattr(self.tts_config.audio, "do_trim_silence", False))
        wav = transfer_voice(self.tts_model, self.tts_config, ref, speaker_id=speaker_id, d_vector=d_vector,
                             reference_speaker_id=ref_id, reference_d_vector=ref_d_vector, do_trim_silence=do_trim,
                             seed=seed)
        wavs = list(np.asarray(wav, dtype=np.float32))
        self._report(start, wavs)
        return wavs

    def _report(self, start: float, wavs) -> None:
        process_time = time.time() - start
        audio_time = len(wavs) / self.output_sample_rate
        print(f" > Processing time: {process_time}")
        print(f" > Real-time factor: {process_time / max(audio_time, 1e-9)}")


def _interpolate_mel(mel: np.ndarray, scale_factor: float) -> np.ndarray:
    """Linear interpolation of a mel `[T, C]` along time by `scale_factor`."""
    T, C = mel.shape
    new_T = int(round(T * scale_factor))
    x_old = np.linspace(0, 1, T)
    x_new = np.linspace(0, 1, new_T)
    return np.stack([np.interp(x_new, x_old, mel[:, c]) for c in range(C)], axis=1)
