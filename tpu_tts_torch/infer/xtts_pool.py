"""Multi-stream XTTS streaming: continuous batched decoding.

Counterpart of `tpu_tts/infer/xtts_pool.py` (`XttsStreamPool`:82, `submit`
:281, `close`:313, `_select_round`:516, `_serve_round_inner`:602, `_admit`
:761, `_emit`:818). Concurrent `/api/tts_stream` requests share one batch
on the leading axis and go through the model's own `stream_prefill`,
`stream_chunk` and `decode_latents`, so B streams pay for one weight
stream per decode step.

- A round starts from the oldest queued request (or one deferred
  `max_deferrals` rounds, which seeds the next round itself) plus every
  queued request of its text-length bucket (`Xtts.TEXT_BUCKET`), gathered
  in a short window. The round's conditioning width is the largest width
  bucket (`num_cond_latents` multiples) among them: narrower rows are
  right-padded on the latent axis and masked with `cond_lengths`.
- At every chunk boundary, queued requests of the round's bucket and of a
  width that fits are admitted into free slots (finished rows), or into
  new rows up to `max_streams`: a prefill of the prompt rows alone is
  spliced into the round's cache, and the row carries `audio_start = i0`,
  so its audio positions count from its own start while its cache writes
  share the round's absolute index (the key mask hides the gap). The chunk
  right after an admission is `first_chunk_size` long.
- Emission is per row and phase-aligned: each row stores its valid latents
  in its own history and emits them in its own [first_chunk, chunk, ...]
  cadence, decoded with `overlap_latents` of left context, as the
  single-stream `inference_stream` does; rows of one emission shape decode
  in one call. Per-request `max_tokens` caps a row's budget; latents past
  it are never decoded.
- Rows that finish free their slots; with nothing waiting, a round whose
  live rows are at most half its batch is compacted to its live rows.
- Near `kv_cache_len` the shared timeline is rebased: the last
  `max_new_tokens + max(chunk, first_chunk)` audio rows move down to the
  prompt boundary and `audio_start` shifts with them, so a round fed
  without pause never drains.

With `top_k=1` every pooled stream is the argmax of its own logits, so it
reproduces its solo `inference_stream` up to the summation order of
another batch size; sampled streams draw from the round's generator.

Where the port differs from JAX on purpose (ROADMAP.md, queue 3): no
power-of-two padding of batches, admission groups or emission groups, no
fixed B_max + 1-row history with a trash row and no warm-up ladder (they
bound XLA's compiled programs; no result depends on them), and each
request's history is `max_new_tokens + max(chunk, first_chunk)` long
(JAX's `max_new_tokens + chunk` overflows when `first_chunk > chunk`).
Compaction and mid-round admission are always on and every round's
generator is seeded with 0: JAX's `compact`, `admit_mid_round` and `seed`
options, at their defaults. A request of another bucket still waits for
the round to end, which under continuous same-bucket traffic and
rebasing may be never, as in JAX.
"""

import queue
import threading
import time
import traceback
from typing import Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_tts_torch.ops.helpers import bucket_len


class _Request:
    __slots__ = ("text_tokens", "cond", "spk", "max_tokens", "out", "deferrals", "codes")

    def __init__(self, text_tokens, cond, spk, max_tokens=None):
        self.text_tokens = text_tokens  # np [T]
        self.cond = cond  # [1, n_cond, C]
        self.spk = spk  # [1, d]
        self.max_tokens = max_tokens  # per-request decode budget (None: the pool's)
        self.out: "queue.Queue" = queue.Queue()
        self.deferrals = 0  # rounds started without this request
        self.codes: List[int] = []  # the GPT codes of the latents stored so far


class _Stream:
    """The iterator `submit` returns: a request's waveform chunks in order;
    `codes` holds the GPT codes they were decoded from (a check can replay
    them teacher-forced)."""

    def __init__(self, req: _Request):
        self._req = req
        self._done = False

    @property
    def codes(self) -> List[int]:
        return self._req.codes

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._done:
            raise StopIteration
        item = self._req.out.get()
        if item is None or isinstance(item, Exception):
            self._done = True
            if item is None:
                raise StopIteration
            raise item
        return item


class XttsStreamPool:
    def __init__(self, model, max_streams: int = 4, stream_chunk_size: int = 20, first_chunk_size: int = 8,
                 overlap_latents: int = 4, max_new_tokens: int = 256, temperature: float = 0.75, top_k: int = 50,
                 gather_window_s: float = 0.02, max_deferrals: int = 2):
        self.model = model
        self.max_streams = int(max_streams)
        self.chunk = int(stream_chunk_size)
        self.first_chunk = int(first_chunk_size)
        self.overlap = int(overlap_latents)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.gather_window_s = float(gather_window_s)
        self.max_deferrals = int(max_deferrals)
        if self.first_chunk < self.overlap:
            raise ValueError(f"first_chunk_size ({self.first_chunk}) must be >= overlap_latents ({self.overlap}): "
                             "a row's overlap context is sliced from its own emitted history")
        # a row's history, and the audio rows a rebase keeps: the budget plus
        # the longest chunk that may overshoot it
        self._hist_len = self.max_new_tokens + max(self.chunk, self.first_chunk)
        # observability: a serial fallback would show rounds_served equal to
        # the requests and no admissions
        self.rounds_served = 0
        self.admissions = 0
        self.decode_calls = 0  # batched decode_latents calls (each is one K1 pass over 4 stages)
        self.compactions = 0
        self.rebases = 0
        self._in: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._closed = False
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------- api
    def submit(self, text: str = None, language: str = "en", gpt_cond_latent=None, speaker_embedding=None,
               text_tokens=None, max_tokens: Optional[int] = None) -> Iterator[np.ndarray]:
        """Enqueue one stream; returns an iterator of float32 waveform chunks
        (with the stream's GPT `codes`). `max_tokens` caps this request's
        decode budget below the pool's `max_new_tokens`."""
        if self._closed:
            raise RuntimeError("pool is closed")
        if text_tokens is None:
            text_tokens = self.model.bpe.encode(text, language)
        tokens = text_tokens.cpu().numpy() if isinstance(text_tokens, torch.Tensor) else np.asarray(text_tokens)
        model = self.model
        req = _Request(tokens.astype(np.int64).reshape(-1),
                       model._float(gpt_cond_latent).reshape(1, -1, model.args.gpt_n_model_channels),
                       model._float(speaker_embedding).reshape(1, -1), max_tokens)
        self._in.put(req)
        return _Stream(req)

    def close(self):
        self._closed = True
        self._in.put(None)
        self._worker.join(timeout=30)

    # ------------------------------------------------------------ scheduling
    def _bucket(self, req: _Request) -> int:
        """The single-stream path's text grid (`Xtts._bucket_text`)."""
        m = self.model
        return bucket_len(req.text_tokens.shape[0], m.TEXT_BUCKET, cap=m.args.gpt_max_text_tokens + 2)

    def _width(self, req: _Request) -> int:
        """Conditioning width on the model's latent-count grid (a
        multi-reference speaker stacks k × num_cond_latents latents)."""
        return bucket_len(int(req.cond.shape[1]), int(self.model.args.num_cond_latents))

    def _budget(self, req: _Request) -> int:
        return min(req.max_tokens or self.max_new_tokens, self.max_new_tokens)

    def _drain(self, pending: List[_Request], timeout: float = 0.0):
        """Move queued arrivals into `pending`; flips `_stop` on shutdown."""
        deadline = time.monotonic() + timeout
        while True:
            t = deadline - time.monotonic()
            try:
                req = self._in.get(timeout=t) if t > 0 else self._in.get_nowait()
            except queue.Empty:
                return
            if req is None:
                self._stop = True
                return
            pending.append(req)

    def _select_round(self, pending: List[_Request]):
        """The next round: the oldest request, or a starved one past
        `max_deferrals`, seeds it, joined by every same-bucket request.
        Returns (still pending, batch, bucket)."""
        seed = next((r for r in pending if r.deferrals >= self.max_deferrals), pending[0])
        bucket = self._bucket(seed)
        batch = [seed] + [r for r in pending if r is not seed and self._bucket(r) == bucket][: self.max_streams - 1]
        for r in pending:
            if r not in batch:
                r.deferrals += 1
        return [r for r in pending if r not in batch], batch, bucket

    def _run(self):
        pending: List[_Request] = []
        while True:
            if self._stop:
                self._drain(pending)  # requests still queued must not strand
                for r in pending:
                    r.out.put(None)
                return
            if not pending:
                req = self._in.get()  # block until there is work
                if req is None:
                    self._stop = True
                    continue
                pending.append(req)
            self._drain(pending, timeout=self.gather_window_s)
            if not pending:
                continue
            pending, batch, bucket = self._select_round(pending)
            self._serve_round(batch, bucket, pending)

    # ------------------------------------------------------------- one round
    def _prefill_batch(self, reqs: List[_Request], bucket: int, W: int, cache_len: int = None):
        """Right-pad `reqs` to a `[k, bucket]` text and `[k, W]` cond batch and
        prefill it: (cache, prompt_len, codes, text_lengths, cond_lengths, spk)."""
        dev = self.model.device
        text = torch.from_numpy(np.stack([np.pad(r.text_tokens, (0, bucket - r.text_tokens.shape[0])) for r in reqs]))
        text_lengths = torch.tensor([r.text_tokens.shape[0] for r in reqs], device=dev)
        cond_lengths = torch.tensor([r.cond.shape[1] for r in reqs], device=dev)
        cond = torch.cat([F.pad(r.cond, (0, 0, 0, W - r.cond.shape[1])) for r in reqs])
        spk = torch.cat([r.spk for r in reqs])
        cache, prompt_len, code = self.model.net.stream_prefill(cond, text.to(dev), text_lengths, cond_lengths,
                                                                cache_len=cache_len)
        return cache, prompt_len, code, text_lengths, cond_lengths, spk

    def _serve_round(self, batch, bucket, pending):
        self.rounds_served += 1
        all_reqs = list(batch)
        closed = set()

        def close(req, err=None):
            if id(req) not in closed:
                closed.add(id(req))
                if err is not None:
                    req.out.put(err)
                req.out.put(None)

        try:
            with torch.no_grad():
                self._serve_round_inner(batch, bucket, pending, all_reqs, close)
        except Exception as e:  # the worker keeps serving; every caller of the round gets the error
            traceback.print_exc()
            for req in all_reqs:
                close(req, err=e)

    def _serve_round_inner(self, batch, bucket, pending, all_reqs, close):
        model, net = self.model, self.model.net
        W = max(self._width(r) for r in batch)
        st = {"slots": list(batch)}  # the round's live state, shared with _admit
        (st["cache"], prompt_len, st["code"], st["text_lengths"], st["cond_lengths"],
         st["spk"]) = self._prefill_batch(batch, bucket, W)
        B = len(batch)
        st["stopped"] = torch.zeros(B, dtype=torch.bool, device=model.device)
        st["audio_start"] = torch.zeros(B, dtype=torch.long, device=model.device)
        gen = torch.Generator(device=model.device).manual_seed(0)
        # admission must not truncate a newcomer's budget: it joins only while
        # its whole budget still fits on the shared timeline
        cache_cap = int(model.args.kv_cache_len) - (W + bucket)
        rows = {}  # id(req) -> per-row state

        def track(req):
            all_reqs.append(req)
            rows[id(req)] = {"done": False, "eptr": 0, "emitted": 0, "budget": self._budget(req), "first": True,
                             "hist": torch.zeros(self._hist_len, model.args.gpt_n_model_channels, device=model.device)}

        for r in batch:
            track(r)
        i0 = 0
        while True:
            just_admitted = False
            if not self._stop:
                self._drain(pending)
                adm0 = self.admissions
                self._admit(pending, st, bucket, W, i0, cache_cap, rows, track)
                just_admitted = self.admissions > adm0
            slots = st["slots"]
            if not [r for r in slots if not rows[id(r)]["done"]]:
                break
            # a small chunk right after an admission gets the newcomers' first
            # audio out sooner; emission is per row, so no row's cadence moves
            size = self.first_chunk if (i0 == 0 or just_admitted) else self.chunk
            if i0 + size > cache_cap:
                shift = i0 - self._hist_len
                if shift <= 0:
                    break  # the cache is shorter than one budget window: drain
                keep = st["cache"][:, :, prompt_len + shift : prompt_len + shift + self._hist_len].clone()
                st["cache"][:, :, prompt_len : prompt_len + self._hist_len] = keep
                st["audio_start"] -= shift
                i0 = self._hist_len
                self.rebases += 1
            (st["cache"], st["code"], st["stopped"]), (codes, lats, valid) = net.stream_chunk(
                st["cache"], prompt_len, st["code"], st["stopped"], gen, i0, size, self.temperature, self.top_k,
                st["text_lengths"], W, st["cond_lengths"], st["audio_start"])
            n_valid = valid.sum(dim=1).tolist()  # the host reads these three a chunk
            stopped, codes = st["stopped"].tolist(), codes.tolist()
            newly_done = []
            for i, req in enumerate(slots):
                row = rows[id(req)]
                if row["done"]:
                    continue
                nv = min(int(n_valid[i]), max(0, row["budget"] - row["emitted"]))
                row["hist"][row["emitted"] : row["emitted"] + nv] = lats[i, :nv]
                req.codes += codes[i][:nv]
                row["emitted"] += nv
                if nv < size or stopped[i] or row["emitted"] >= row["budget"]:
                    row["done"] = True
                    newly_done.append(req)
            self._emit(slots, rows)
            for req in newly_done:
                close(req)  # its tail, if any, was just emitted
                rows[id(req)]["hist"] = None  # a round fed without pause must not keep every history
            i0 += size
            live_idx = [i for i, r in enumerate(slots) if not rows[id(r)]["done"]]
            if not live_idx:
                if not self._stop and (pending or not self._in.empty()):
                    continue  # the round stays open for same-bucket admission
                break
            # compaction: drop dead rows once half the batch has finished,
            # unless queued requests could reuse their slots
            if len(slots) > 1 and len(live_idx) <= len(slots) // 2 and not pending and self._in.empty():
                idx = torch.tensor(live_idx, device=model.device)
                st["cache"] = st["cache"].index_select(3, idx)
                for key in ("code", "stopped", "text_lengths", "cond_lengths", "audio_start", "spk"):
                    st[key] = st[key].index_select(0, idx)
                st["slots"] = [slots[i] for i in live_idx]
                self.compactions += 1
        self._emit(st["slots"], rows, flush=True)  # buffered tails of rows cut short
        for req in all_reqs:
            close(req)

    # -------------------------------------------------------------- admission
    def _admit(self, pending, st, bucket, W, i0, cache_cap, rows, track):
        """Splice compatible pending requests into the live round at absolute
        step `i0`: into the slots of finished rows, then into new rows up to
        `max_streams`."""
        slots = st["slots"]
        n_live = sum(1 for r in slots if not rows[id(r)]["done"])
        ok = [r for r in pending
              if self._bucket(r) == bucket and self._width(r) <= W and self._budget(r) + i0 <= cache_cap
              ][: self.max_streams - n_live]
        if not ok:
            return
        free = [i for i, r in enumerate(slots) if rows[id(r)]["done"]]
        grow = min(len(ok) - len(free), self.max_streams - len(slots))
        take = ok[: len(free) + max(grow, 0)]
        if grow > 0:
            L, two, T_max, _, H, D = st["cache"].shape
            st["cache"] = torch.cat([st["cache"], st["cache"].new_zeros(L, two, T_max, grow, H, D)], dim=3)
            for key in ("code", "stopped", "text_lengths", "cond_lengths", "audio_start"):
                st[key] = torch.cat([st[key], st[key][:1].expand(grow).clone()])
            st["spk"] = torch.cat([st["spk"], st["spk"][:1].expand(grow, -1)])
            free += list(range(len(slots), len(slots) + grow))
            slots += [None] * grow
        for r in take:
            pending.remove(r)
        slot_idx = free[: len(take)]
        ncache, prompt_len, ncode, ntl, ncl, nspk = self._prefill_batch(take, bucket, W, cache_len=W + bucket)
        for i, r in zip(slot_idx, take):
            slots[i] = r
            track(r)
        idx = torch.tensor(slot_idx, device=self.model.device)
        # the prompt rows only; the slot's stale audio rows stay, hidden by the
        # newcomer's audio_start key mask
        st["cache"][:, :, :prompt_len, idx] = ncache
        st["code"][idx] = ncode
        st["stopped"][idx] = False
        st["text_lengths"][idx] = ntl
        st["cond_lengths"][idx] = ncl
        st["audio_start"][idx] = i0
        st["spk"][idx] = nspk
        self.admissions += len(take)

    # --------------------------------------------------------------- emission
    def _emit(self, slots, rows, flush: bool = False):
        """Each row emits its stored latents in its own [first_chunk, chunk,
        ...] cadence with `overlap` latents of left context, as
        `inference_stream` does; the zeros past a row's stored latents are
        the tail's padding. Rows of one (size, first) shape decode in one
        call; chunks reach each request in order."""
        model = self.model
        plans = []  # (req, esize, n_emit, first, start)
        for req in slots:
            if req is None:
                continue
            row = rows[id(req)]
            while True:
                buffered = row["emitted"] - row["eptr"]
                esize = self.first_chunk if row["first"] else self.chunk
                if buffered >= esize:
                    n_emit = esize
                elif (row["done"] or flush) and buffered > 0:
                    n_emit = buffered
                else:
                    break
                plans.append((req, esize, n_emit, row["first"], row["eptr"]))
                row["eptr"] += n_emit
                row["first"] = False
        groups = {}
        for pi, plan in enumerate(plans):
            groups.setdefault((plan[1], plan[3]), []).append(pi)
        wavs = [None] * len(plans)
        ovl = self.overlap
        for (esize, first), idxs in groups.items():
            ctx = 0 if (first or not ovl) else ovl
            x = torch.stack([rows[id(plans[pi][0])]["hist"][plans[pi][4] - ctx : plans[pi][4] + esize] for pi in idxs])
            spk = torch.cat([plans[pi][0].spk for pi in idxs])
            wav = model.net.decode_latents(x, spk).cpu().numpy()
            self.decode_calls += 1
            lead = model._n_samples(ctx)
            for g, pi in enumerate(idxs):
                wavs[pi] = wav[g, lead : lead + model._n_samples(plans[pi][2])]
        for pi, plan in enumerate(plans):
            plan[0].out.put(wavs[pi])
