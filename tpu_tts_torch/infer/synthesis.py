"""Single-utterance synthesis: tokenize → `model.inference` → waveform or mel.

Counterpart of `tpu_tts/infer/synthesis.py` (`trim_silence`:16,
`inv_spectrogram`:20, `synthesis`:26): an end-to-end model (VITS,
DelightfulTTS) gives the waveform; a mel model (Glow-TTS) gives its mel,
which the synthesizer hands to a vocoder, or which Griffin-Lim turns into a
waveform on the host when `use_griffin_lim` is set. `do_trim_silence` cuts
the waveform at `ap.find_endpoint`. A speaker id, a d-vector and a language id reach the
model as one-row `speaker_ids`, `d_vectors` and `language_ids`; the
language's name also picks the tokenizer's phonemizer, as in JAX.
`transfer_voice` (`:80`) is VITS voice conversion: a reference waveform
from its speaker into the target speaker's voice.
"""

from typing import Dict, Optional

import numpy as np

# model families whose inference returns the waveform
END2END_MODELS = {"vits", "delightful_tts"}


def trim_silence(wav: np.ndarray, ap) -> np.ndarray:
    return wav[: ap.find_endpoint(wav)]


def inv_spectrogram(postnet_output: np.ndarray, ap, CONFIG, seed=None) -> np.ndarray:
    """A model's normalised spectrogram `[T, C]` → waveform by Griffin-Lim;
    `seed` (an int or a `np.random.Generator`) draws its first phases."""
    if CONFIG.model.lower() in ("tacotron",):
        return ap.inv_spectrogram(postnet_output.T, seed=seed)
    return ap.inv_melspectrogram(postnet_output.T, seed=seed)


def language_of_id(model, language_id: Optional[int]) -> Optional[str]:
    """The name the model's language manager gives `language_id`, else None."""
    manager = getattr(model, "language_manager", None)
    if language_id is None or manager is None:
        return None
    names = [k for k, v in manager.name_to_id.items() if v == language_id]
    return names[0] if names else None


def synthesis(model, text: str, CONFIG, speaker_id: Optional[int] = None, use_griffin_lim: bool = False,
              do_trim_silence: bool = False, d_vector=None, language_id: Optional[int] = None,
              seed: int = 0) -> Dict:
    """Returns `wav` (float32 samples of the valid length, frames · hop; for a
    mel model the Griffin-Lim waveform if `use_griffin_lim`, else None),
    `model_outputs` (a mel model's mel `[T, C]` of the valid length),
    `alignments` and `text_inputs`. `seed` seeds the model's noise and
    Griffin-Lim's first phases."""
    token_ids = np.asarray(model.tokenizer.text_to_ids(text, language=language_of_id(model, language_id)),
                           dtype=np.int64)
    aux_input = {"seed": seed}
    if speaker_id is not None:
        aux_input["speaker_ids"] = [speaker_id]
    if d_vector is not None:
        aux_input["d_vectors"] = np.asarray(d_vector, dtype=np.float32).reshape(1, -1)
    if language_id is not None:
        aux_input["language_ids"] = [language_id]
    outputs = model.inference(token_ids, aux_input=aux_input)
    model_outputs = outputs["model_outputs"].float().cpu().numpy()
    y_len = int(outputs["y_lengths"][0])
    wav = None
    if CONFIG.model.lower() in END2END_MODELS or model_outputs.shape[-1] == 1:
        wav = model_outputs[0, : y_len * model.ap.hop_length, 0]
    else:
        model_outputs = model_outputs[0, :y_len]
        if use_griffin_lim:
            wav = inv_spectrogram(model_outputs, model.ap, CONFIG, seed=seed)
    if wav is not None and do_trim_silence:
        wav = trim_silence(wav, model.ap)
    return {
        "wav": wav,
        "model_outputs": model_outputs,
        "alignments": outputs["alignments"].cpu().numpy(),
        "text_inputs": token_ids,
    }


def transfer_voice(model, CONFIG, reference_wav, speaker_id=None, d_vector=None, reference_speaker_id=None,
                   reference_d_vector=None, do_trim_silence: bool = False, seed: int = 0) -> np.ndarray:
    """`reference_wav` (spoken by the reference speaker, an id or a d-vector)
    in the voice of `speaker_id` or `d_vector`; `seed` draws the posterior's ε."""
    src = reference_speaker_id if reference_speaker_id is not None else reference_d_vector
    tgt = speaker_id if speaker_id is not None else d_vector
    wav = model.voice_conversion(reference_wav, src, tgt, seed=seed)
    if do_trim_silence:
        wav = trim_silence(wav, model.ap)
    return wav
