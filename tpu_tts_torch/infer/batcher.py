"""Micro-batching queue for blocking `/api/tts` requests.

Counterpart of `tpu_tts/infer/batcher.py` (`TTSMicroBatcher`:56,
`supports`:73-88, `_run`:121, `_serve`:147). Without it the server
serialises whole requests behind one lock, and a VITS request pays its
host time (Python between the small kernels of the duration stage, and the
host sync that picks the decode bucket) once per sentence. Concurrent
requests share one batched `Vits.inference` call instead, so that host time
is paid once per batch.

Natural batching: the first request runs at once (after an optional
gather window); requests that arrive while a batch runs queue up and form
the next one. All queued sentences stack into one `[B, T]` id batch: rows
right-padded to the longest row with per-row `x_lengths`, and B padded to a
power of two by repeating row 0, whose outputs are dropped. One
`inference` call serves at most `max_batch` rows; its waveform
`[B, T·hop, 1]` is copied to the host once, cropped per row at
`y_lengths · hop`, trimmed when the audio config says so, and reassembled
per request with the 10000-sample gap of the locked path. An exception in
a batch reaches every request waiting on it.

On the card every row goes through the generator's MRF kernel (K1) in the
same launches: 72 per `inference` call of a VITS generator, whatever B. The
kernel's library is built and loaded before the worker serves.

At the served noise scales a row's noise is drawn from the batch's
generator, so a batched sentence is a different draw than the same sentence
served alone, as in the JAX package (ROADMAP.md, queue 3); at noise scales
0 the two agree.
"""

import queue
import threading
import time
from typing import List, Optional

import numpy as np

from tpu_tts_torch.infer.synthesis import trim_silence
from tpu_tts_torch.infer.synthesizer import SENTENCE_GAP


class _Job:
    __slots__ = ("sent_ids", "out")

    def __init__(self, sent_ids):
        self.sent_ids = sent_ids  # one int64 array [T_i] per sentence
        self.out: "queue.Queue" = queue.Queue()


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class TTSMicroBatcher:
    # end-to-end models whose `inference` honours per-row `x_lengths`
    BATCHABLE_MODELS = {"vits"}

    def __init__(self, synthesizer, max_batch: int = 16, gather_window_s: float = 0.0):
        self.synth = synthesizer
        self.model = synthesizer.tts_model
        self.max_batch = int(max_batch)
        self.gather_window_s = float(gather_window_s)
        # what ran: a serial path would show batches_run == sentences
        self.batches_run = 0
        self.rows_run = 0
        self.batch_sizes: List[int] = []  # padded B of each inference call
        self._in: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._closed = False
        if self.model.device.type == "cuda":
            from tpu_tts_torch.ops import hifigan_mrf

            hifigan_mrf.load_kernel()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    @classmethod
    def supports(cls, synthesizer) -> bool:
        """End-to-end batch models only: `inference` returns the waveform of a
        whole `[B, T]` id batch with per-row length masks."""
        model = getattr(synthesizer, "tts_model", None)
        cfg = getattr(synthesizer, "tts_config", None)
        return (
            model is not None
            and not hasattr(model, "synthesize")
            and hasattr(model, "inference")
            and str(getattr(cfg, "model", "")).lower() in cls.BATCHABLE_MODELS
        )

    # ------------------------------------------------------------------- api
    def tts(self, text: str, speaker_name: str = "", language_name: str = "", speaker_wav=None) -> np.ndarray:
        """Blocking: the float32 waveform of `text`. Safe to call from many
        server threads; concurrent calls share one batch."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        speaker_id, d_vector = self.synth.resolve_speaker(speaker_name, speaker_wav)
        if speaker_id is not None or d_vector is not None or self.synth.resolve_language(language_name) is not None:
            raise NotImplementedError("per-row speaker and language conditioning is not ported yet (ROADMAP.md, M5c)")
        sents = self.synth.split_into_sentences(text)
        job = _Job([np.asarray(self.model.tokenizer.text_to_ids(s), dtype=np.int64) for s in sents])
        self._in.put(job)
        result = job.out.get()
        if isinstance(result, Exception):
            raise result
        return result

    def close(self):
        self._closed = True
        self._in.put(None)
        self._worker.join(timeout=30)

    # ---------------------------------------------------------------- worker
    def _run(self):
        while True:
            job = self._in.get()
            if job is None:
                return
            jobs = [job]
            deadline = time.monotonic() + self.gather_window_s
            # drain everything already queued (and whatever arrives inside the
            # gather window) into this batch
            while sum(len(j.sent_ids) for j in jobs) < self.max_batch:
                t = deadline - time.monotonic()
                try:
                    nxt = self._in.get(timeout=t) if t > 0 else self._in.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._in.put(None)
                    break
                jobs.append(nxt)
            try:
                self._serve(jobs)
            except Exception as e:  # every waiting request gets the error
                for j in jobs:
                    j.out.put(e)

    def _serve(self, jobs: List[_Job]):
        model, cfg = self.model, self.synth.tts_config
        rows = [(j, ids) for j in jobs for ids in j.sent_ids]
        hop = model.ap.hop_length
        do_trim = bool(getattr(cfg.audio, "do_trim_silence", False)) and model.ap is not None
        waves = {id(j): [] for j in jobs}
        for start in range(0, len(rows), self.max_batch):
            chunk = rows[start : start + self.max_batch]
            B = _pow2_ceil(len(chunk))
            T = max(ids.shape[0] for _, ids in chunk)
            x = np.zeros((B, T), dtype=np.int64)
            x_lengths = np.zeros((B,), dtype=np.int64)
            for i in range(B):
                _, ids = chunk[i if i < len(chunk) else 0]  # pad rows repeat row 0
                x[i, : ids.shape[0]] = ids
                x_lengths[i] = ids.shape[0]
            out = model.inference(x, aux_input={"x_lengths": x_lengths})
            wav = out["model_outputs"][..., 0].float().cpu().numpy()  # [B, T·hop], one copy a batch
            y_lengths = out["y_lengths"].cpu().numpy()
            self.batches_run += 1
            self.rows_run += len(chunk)
            self.batch_sizes.append(B)
            for i, (j, _ids) in enumerate(chunk):
                w = wav[i, : int(y_lengths[i]) * hop]
                if do_trim:
                    w = trim_silence(w, model.ap)
                waves[id(j)].append(w)
        silence = np.zeros((SENTENCE_GAP,), dtype=np.float32)
        for j in jobs:
            parts = []
            for w in waves[id(j)]:
                parts += [w, silence]
            j.out.put(np.concatenate(parts) if parts else np.zeros((0,), np.float32))
