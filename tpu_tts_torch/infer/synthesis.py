"""Single-utterance synthesis: tokenize → `model.inference` → waveform or mel.

Counterpart of `tpu_tts/infer/synthesis.py` (`synthesis`:26): an end-to-end
model (VITS) gives the waveform, a mel model (Glow-TTS) its mel, which the
synthesizer hands to a vocoder. Griffin-Lim is not ported (ROADMAP.md).
"""

from typing import Dict, Optional

import numpy as np

# model families whose inference returns the waveform
END2END_MODELS = {"vits"}


def synthesis(model, text: str, CONFIG, speaker_id: Optional[int] = None, d_vector=None,
              language_id: Optional[int] = None, seed: int = 0) -> Dict:
    """Returns `wav` (float32 samples of the valid length, frames · hop; None
    for a mel model), `model_outputs` (a mel model's mel `[T, C]` of the
    valid length), `alignments` and `text_inputs`."""
    if speaker_id is not None or d_vector is not None or language_id is not None:
        raise NotImplementedError("multi-speaker and multi-language synthesis is not ported yet (ROADMAP.md, queue 1)")
    token_ids = np.asarray(model.tokenizer.text_to_ids(text), dtype=np.int64)
    outputs = model.inference(token_ids, aux_input={"seed": seed})
    model_outputs = outputs["model_outputs"].float().cpu().numpy()
    y_len = int(outputs["y_lengths"][0])
    wav = None
    if CONFIG.model.lower() in END2END_MODELS or model_outputs.shape[-1] == 1:
        wav = model_outputs[0, : y_len * model.ap.hop_length, 0]
    else:
        model_outputs = model_outputs[0, :y_len]
    return {
        "wav": wav,
        "model_outputs": model_outputs,
        "alignments": outputs["alignments"].cpu().numpy(),
        "text_inputs": token_ids,
    }
