"""Single-utterance synthesis: tokenize → `model.inference` → waveform or mel.

Counterpart of `tpu_tts/infer/synthesis.py` (`trim_silence`:16,
`inv_spectrogram`:20, `synthesis`:26): an end-to-end model (VITS) gives the
waveform; a mel model (Glow-TTS) gives its mel, which the synthesizer hands
to a vocoder, or which Griffin-Lim turns into a waveform on the host when
`use_griffin_lim` is set. `do_trim_silence` cuts the waveform at
`ap.find_endpoint`.
"""

from typing import Dict, Optional

import numpy as np

# model families whose inference returns the waveform
END2END_MODELS = {"vits"}


def trim_silence(wav: np.ndarray, ap) -> np.ndarray:
    return wav[: ap.find_endpoint(wav)]


def inv_spectrogram(postnet_output: np.ndarray, ap, CONFIG, seed=None) -> np.ndarray:
    """A model's normalised spectrogram `[T, C]` → waveform by Griffin-Lim;
    `seed` (an int or a `np.random.Generator`) draws its first phases."""
    if CONFIG.model.lower() in ("tacotron",):
        return ap.inv_spectrogram(postnet_output.T, seed=seed)
    return ap.inv_melspectrogram(postnet_output.T, seed=seed)


def synthesis(model, text: str, CONFIG, speaker_id: Optional[int] = None, use_griffin_lim: bool = False,
              do_trim_silence: bool = False, d_vector=None, language_id: Optional[int] = None,
              seed: int = 0) -> Dict:
    """Returns `wav` (float32 samples of the valid length, frames · hop; for a
    mel model the Griffin-Lim waveform if `use_griffin_lim`, else None),
    `model_outputs` (a mel model's mel `[T, C]` of the valid length),
    `alignments` and `text_inputs`. `seed` seeds the model's noise and
    Griffin-Lim's first phases."""
    if speaker_id is not None or d_vector is not None or language_id is not None:
        raise NotImplementedError("multi-speaker and multi-language synthesis is not ported yet (ROADMAP.md, M5c)")
    token_ids = np.asarray(model.tokenizer.text_to_ids(text), dtype=np.int64)
    outputs = model.inference(token_ids, aux_input={"seed": seed})
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
