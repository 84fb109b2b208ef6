"""GPT decoder of XTTS over [conditioning latents | text tokens | mel codes].

Counterpart of `tpu_tts/layers/xtts/gpt.py` (`CausalSelfAttention`:19,
`GPTBlock`:75, `XttsGPT`:90 with its teacher-forced `__call__`:125,
`init_cache`:143, `key_valid_mask`:157, `prefill`:182 and
`decode_step`:221). Attribute names are those of Coqui's XTTS-v2 state dict
(`gpt.gpt.h.{i}.attn.c_attn`, `gpt.mel_embedding`, ...), so a Coqui
checkpoint loads as is: GPT-2's `Conv1D` keeps its `[in, out]` weight, and
the conditioning encoder and perceiver live under the GPT, as there.

The KV cache is ONE tensor `[n_layer, 2, T_max, B, H, D]`: per layer a
time-major `[T_max, B, H, D]` key and value, as in JAX, so that a decode
step writes one contiguous `[1, B, H, D]` block, and the pool splices,
grows, gathers and rebases rows of all layers with one indexing op. Its
dtype follows the parameters. Writes are in place.

Attention masks with -1e9 before the softmax, as JAX does: a causal limit
over the cache rows and an optional key-side validity mask `[B, T_max]`,
combined once a forward (`attention_blocked`) and applied in every layer
(both of JAX's replacements write -1e9, so one replacement with their
union is the same). Each call attends over the cache rows up to its last
written one; the rows past them are masked in JAX, where
exp(-1e9 - max) is exactly 0, so the result is the same.
"""

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.layers.xtts.perceiver import ConditioningEncoder, PerceiverResampler


class Conv1D(nn.Module):
    """GPT-2's linear layer: weight `[in, out]`, y = x·W + b."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out).normal_(0.0, 0.02))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return torch.addmm(self.bias, x.reshape(-1, x.shape[-1]), self.weight).reshape(*x.shape[:-1], -1)


class LearnedPositionEmbeddings(nn.Module):
    def __init__(self, seq_len: int, dim: int):
        super().__init__()
        self.emb = nn.Embedding(seq_len, dim)

    def forward(self, pos):
        return self.emb(pos)


def attention_blocked(T: int, cache_index: int, mask, device) -> torch.Tensor:
    """Keys each of T queries may not see, `[B or 1, 1, T, cache_index + T]`:
    those past its causal limit (query t sits at cache_index + t), and the
    rows `mask` `[B, ≥ cache_index + T]` marks invalid."""
    end = cache_index + T
    blocked = torch.arange(end, device=device)[None, :] > (cache_index + torch.arange(T, device=device))[:, None]
    blocked = blocked[None, None]
    if mask is not None:
        blocked = blocked | ~mask[:, None, None, :end]
    return blocked


class CausalSelfAttention(nn.Module):
    def __init__(self, n_head: int, n_embd: int):
        super().__init__()
        self.n_head = n_head
        self.c_attn = Conv1D(n_embd, 3 * n_embd)
        self.c_proj = Conv1D(n_embd, n_embd)

    def forward(self, x, blocked, cache=None, cache_index: int = 0):
        """x `[B, T, C]`; `blocked` from `attention_blocked`. With `cache`
        (`[2, T_max, B, H, D]`, written in place) attends over the cache
        rows up to `cache_index + T` (prefill at 0, or a decode step);
        without it, over x alone."""
        B, T, C = x.shape
        H = self.n_head
        D = C // H
        q, k, v = self.c_attn(x).split(C, dim=-1)
        q = q.reshape(B, T, H, D)
        k, v = k.reshape(B, T, H, D).transpose(0, 1), v.reshape(B, T, H, D).transpose(0, 1)  # [T, B, H, D]
        if cache is not None:
            end = cache_index + T
            cache[0, cache_index:end] = k
            cache[1, cache_index:end] = v
            k, v = cache[0, :end], cache[1, :end]  # [S, B, H, D]
        att = torch.einsum("bthd,sbhd->bhts", q, k) / math.sqrt(D)
        att = torch.softmax(att.masked_fill(blocked, -1e9), dim=-1)
        return self.c_proj(torch.einsum("bhts,sbhd->bthd", att, v).reshape(B, T, C))


class GPTMlp(nn.Module):
    def __init__(self, n_embd: int):
        super().__init__()
        self.c_fc = Conv1D(n_embd, 4 * n_embd)
        self.c_proj = Conv1D(4 * n_embd, n_embd)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class GPTBlock(nn.Module):
    def __init__(self, n_head: int, n_embd: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(n_embd, eps=1e-5)
        self.attn = CausalSelfAttention(n_head, n_embd)
        self.ln_2 = nn.LayerNorm(n_embd, eps=1e-5)
        self.mlp = GPTMlp(n_embd)

    def forward(self, x, blocked, cache=None, cache_index: int = 0):
        x = x + self.attn(self.ln_1(x), blocked, cache=cache, cache_index=cache_index)
        return x + self.mlp(self.ln_2(x))


class GPT2Stack(nn.Module):
    """The transformer of Coqui's `gpt.gpt` (blocks `h` and `ln_f`); the
    token and position embeddings live beside it, in `XttsGPT`."""

    def __init__(self, n_layer: int, n_head: int, n_embd: int):
        super().__init__()
        self.h = nn.ModuleList(GPTBlock(n_head, n_embd) for _ in range(n_layer))
        self.ln_f = nn.LayerNorm(n_embd, eps=1e-5)


class XttsGPT(nn.Module):
    """GPT over [cond latents | text tokens | audio codes] with the text and
    mel-code heads and the latent output that feeds the HiFi-GAN decoder."""

    def __init__(self, n_layer: int = 30, n_head: int = 16, n_embd: int = 1024, num_text_tokens: int = 6681,
                 num_audio_tokens: int = 1026, max_text_tokens: int = 402, max_audio_tokens: int = 605,
                 spec_dim: int = 80, num_cond_latents: int = 32):
        super().__init__()
        self.n_layer, self.n_head, self.n_embd = n_layer, n_head, n_embd
        self.conditioning_encoder = ConditioningEncoder(spec_dim, n_embd)
        self.conditioning_perceiver = PerceiverResampler(dim=n_embd, num_latents=num_cond_latents)
        self.text_embedding = nn.Embedding(num_text_tokens, n_embd)
        self.mel_embedding = nn.Embedding(num_audio_tokens, n_embd)
        self.text_pos_embedding = LearnedPositionEmbeddings(max_text_tokens + 2, n_embd)
        self.mel_pos_embedding = LearnedPositionEmbeddings(max_audio_tokens + 3, n_embd)
        self.gpt = GPT2Stack(n_layer, n_head, n_embd)
        # Coqui applies a second LayerNorm (final_norm) after GPT-2's ln_f
        self.final_norm = nn.LayerNorm(n_embd, eps=1e-5)
        self.text_head = nn.Linear(n_embd, num_text_tokens)
        self.mel_head = nn.Linear(n_embd, num_audio_tokens)

    def _text_emb(self, text_tokens):
        pos = torch.arange(text_tokens.shape[1], device=text_tokens.device)
        return self.text_embedding(text_tokens) + self.text_pos_embedding(pos)[None]

    def _norm(self, x):
        return self.final_norm(self.gpt.ln_f(x))

    def forward(self, cond_latents, text_tokens, audio_codes, attn_mask=None) -> Dict[str, torch.Tensor]:
        """Teacher-forced pass: text and mel logits, and the per-code latents."""
        pos = torch.arange(audio_codes.shape[1], device=audio_codes.device)
        a_emb = self.mel_embedding(audio_codes) + self.mel_pos_embedding(pos)[None]
        x = torch.cat([cond_latents, self._text_emb(text_tokens), a_emb], dim=1)
        blocked = attention_blocked(x.shape[1], 0, attn_mask, x.device)
        for blk in self.gpt.h:
            x = blk(x, blocked)
        x = self._norm(x)
        n_cond, n_text = cond_latents.shape[1], text_tokens.shape[1]
        text_latents, audio_latents = x[:, n_cond : n_cond + n_text], x[:, n_cond + n_text :]
        return {"text_logits": self.text_head(text_latents), "mel_logits": self.mel_head(audio_latents),
                "audio_latents": audio_latents}

    # ----------------------------------------------------------- incremental
    def init_cache(self, B: int, T_max: int, dtype=None) -> torch.Tensor:
        """The KV cache `[n_layer, 2, T_max, B, H, D]`, zeros; its dtype
        follows the parameters unless given."""
        dtype = self.text_embedding.weight.dtype if dtype is None else dtype
        H = self.n_head
        return torch.zeros(self.n_layer, 2, T_max, B, H, self.n_embd // H, dtype=dtype,
                           device=self.text_embedding.weight.device)

    @staticmethod
    def key_valid_mask(n_cond: int, prompt_len: int, text_lengths, T_max: int, cond_lengths=None,
                       audio_start=None) -> torch.Tensor:
        """Key-side cache-row validity `[B, T_max]` of a right-padded prompt
        [cond (padded to n_cond) | text (padded) | audio ...]: cond rows up to
        each row's `cond_lengths` (default all), text rows up to each row's
        `text_lengths`, and the audio region from `prompt_len`, from
        `prompt_len + audio_start[b]` for a row that joined the shared
        timeline at step `audio_start[b]` (the pool's admission)."""
        s = torch.arange(T_max, device=text_lengths.device)[None]
        cond_ok = s < (n_cond if cond_lengths is None else cond_lengths[:, None])
        text_ok = (s >= n_cond) & ((s - n_cond) < text_lengths[:, None])
        audio_ok = s >= prompt_len
        if audio_start is not None:
            audio_ok = audio_ok & ((s - prompt_len) >= audio_start[:, None])
        return (cond_ok & (s < n_cond)) | text_ok | audio_ok

    def prefill(self, cond_latents, text_tokens, cache, text_lengths=None, cond_lengths=None):
        """Run the prompt through the stack, writing rows [0, T) of `cache`.
        Returns (cache, prompt_len, last_hidden). With `text_lengths` [B] the
        text is right-padded and a key-side mask hides the pad rows here and
        in later steps; `cond_lengths` [B] does the same for a right-padded
        conditioning track."""
        x = torch.cat([cond_latents.to(self.text_embedding.weight.dtype), self._text_emb(text_tokens)], dim=1)
        T = x.shape[1]
        mask = None
        if text_lengths is not None or cond_lengths is not None:
            if text_lengths is None:
                text_lengths = torch.full(text_tokens.shape[:1], text_tokens.shape[1], dtype=torch.long,
                                          device=text_tokens.device)
            mask = self.key_valid_mask(cond_latents.shape[1], T, text_lengths, cache.shape[2],
                                       cond_lengths=cond_lengths)
        blocked = attention_blocked(T, 0, mask, x.device)
        for blk, c in zip(self.gpt.h, cache):
            x = blk(x, blocked, cache=c)
        return cache, T, self._norm(x)[:, -1]

    def decode_step(self, audio_code, pos_in_audio, cache, cache_index: int, key_valid=None):
        """One incremental step: embed the previous code at its audio
        position (a scalar or `[B]`, made `[B]` before the embedding, as at
        `tpu_tts/layers/xtts/gpt.py`:222-233), attend over the cache, write
        row `cache_index`. Returns (logits `[B, V]`, latent `[B, C]`, cache)."""
        pos = torch.as_tensor(pos_in_audio, device=audio_code.device).reshape(-1).expand(audio_code.shape[0])
        x = (self.mel_embedding(audio_code) + self.mel_pos_embedding(pos))[:, None]
        blocked = attention_blocked(1, cache_index, key_valid, x.device)
        for blk, c in zip(self.gpt.h, cache):
            x = blk(x, blocked, cache=c, cache_index=cache_index)
        x = self._norm(x)[:, 0]
        return self.mel_head(x), x, cache
