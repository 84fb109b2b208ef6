"""VITS losses, the aligner's forward-sum loss and the ForwardTTS losses, in float32.

Counterparts of `tpu_tts/layers/losses.py` (`masked_mse_loss`:46,
`masked_l1_loss`:53, `kl_loss`:67, `forward_sum_loss`:87, `_gaussian_kernel`
:163, `ssim_loss`:172, `binary_alignment_loss`:202, `feature_loss`:209,
`generator_loss`:220, `discriminator_loss`:228).
The port's tensors are channels-first; every loss here is a sum or mean, so
the layout does not change it.
"""

import numpy as np
import torch
import torch.nn.functional as F

_NEG = -1e30  # stands for −inf where F.ctc_loss's backward would form −inf − (−inf)


def wide(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or in float64 if it is: where JAX reads a loss's inputs
    in float32, a float64 run keeps its precision."""
    return x if x.dtype == torch.float64 else x.float()


def _length_mask(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """`[B, T, 1]` 1/0 mask of the first `lengths` frames of `x` `[B, T, C]`, in x's dtype."""
    return (torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]).to(x.dtype)[:, :, None]


def masked_mse_loss(x: torch.Tensor, target: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The mean squared error over each row's first `lengths` frames:
    x, target `[B, T, C]`."""
    x, target = wide(x), wide(target)
    mask = _length_mask(x, lengths)
    return torch.sum((x - target) ** 2 * mask) / (torch.sum(mask) * x.shape[-1])


def masked_l1_loss(x: torch.Tensor, target: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The mean absolute error over each row's first `lengths` frames."""
    x, target = wide(x), wide(target)
    mask = _length_mask(x, lengths)
    return torch.sum(torch.abs(x - target) * mask) / (torch.sum(mask) * x.shape[-1])


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size) - size // 2
    g = np.exp(-(coords**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim_loss(x: torch.Tensor, y: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """1 − SSIM of two spectrograms `[B, T, C]` read as one-channel images,
    zeroed past each row's length and scaled together into [0, 1] by their
    joint min and max (range at least 1e-6); an 11 × 11 Gaussian window
    (σ 1.5) with zero padding, C1 = 0.01², C2 = 0.03²."""
    x, y = wide(x), wide(y)
    mask = _length_mask(x, lengths)
    x, y = (x * mask)[:, None], (y * mask)[:, None]  # [B, 1, T, C]
    mn = torch.minimum(x.min(), y.min())
    rng = torch.clamp(torch.maximum(x.max(), y.max()) - mn, min=1e-6)
    x, y = (x - mn) / rng, (y - mn) / rng
    k = torch.from_numpy(_gaussian_kernel()).to(x)[None, None]

    def f(z):
        return F.conv2d(z, k, padding=k.shape[-1] // 2)

    c1, c2 = 0.01**2, 0.03**2
    mu_x, mu_y = f(x), f(y)
    sigma_x = f(x * x) - mu_x**2
    sigma_y = f(y * y) - mu_y**2
    sigma_xy = f(x * y) - mu_x * mu_y
    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)) / ((mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2))
    return 1.0 - torch.mean(ssim_map)


def binary_alignment_loss(alignment_hard: torch.Tensor, alignment_soft: torch.Tensor) -> torch.Tensor:
    """−Σ log(soft) over the hard path's cells / their count (at least 1):
    pulls the soft attention `[B, T_de, T_en]` toward the MAS path."""
    log_soft = torch.log(torch.clamp(wide(alignment_soft), min=1e-12))
    masked = torch.where(alignment_hard == 1, log_soft, torch.zeros_like(log_soft))
    return -torch.sum(masked) / torch.clamp(torch.sum(alignment_hard), min=1.0)


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask) -> torch.Tensor:
    """KL between the posterior and the flow's prior, per masked frame.
    z_p, logs_q, m_p, logs_p `[B, C, T]`, z_mask `[B, 1, T]`."""
    z_p, logs_q, m_p, logs_p, z_mask = (t.float() for t in (z_p, logs_q, m_p, logs_p, z_mask))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / torch.sum(z_mask)


def feature_loss(feats_real, feats_generated) -> torch.Tensor:
    """GAN feature matching: 2 × Σ mean |real − generated| over every
    discriminator's every feature map; the real side carries no gradient."""
    loss = 0.0
    for dr, dg in zip(feats_real, feats_generated):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach().float() - gl.float()))
    return loss * 2.0


def generator_loss(scores_fake) -> torch.Tensor:
    """LSGAN generator loss over a list of discriminator outputs."""
    loss = 0.0
    for dg in scores_fake:
        loss = loss + torch.mean((1.0 - dg.float()) ** 2)
    return loss


def discriminator_loss(scores_real, scores_fake) -> torch.Tensor:
    """LSGAN discriminator loss."""
    loss = 0.0
    for dr, dg in zip(scores_real, scores_fake):
        loss = loss + torch.mean((1.0 - dr.float()) ** 2) + torch.mean(dg.float() ** 2)
    return loss


def forward_sum_loss(attn_logprob, in_lens, out_lens, blank_logprob: float = -1.0) -> torch.Tensor:
    """The aligner's CTC loss: attn_logprob `[B, 1, T_de, T_en]` (−inf on
    masked tokens), a blank column of `blank_logprob` put first, log_softmax
    over blank + tokens, then the negative log-likelihood of emitting tokens
    1..in_len in order over the first out_len frames, divided by out_len,
    averaged over the batch: −mean(total / out_lens), as `tpu_tts`'s
    log-space forward, not F.ctc_loss's "mean" (which divides by the target
    lengths). −inf log-probs are held at −1e30 first, which changes no
    probability and keeps the gradient finite.

    When every row has at least as many frames as tokens the forward runs in
    F.ctc_loss (`reduction="none"`). A row with more tokens than frames has
    no path; `tpu_tts`'s forward, started at −1e30, then gives a loss of
    about 1e30 / out_len and a finite gradient, where F.ctc_loss gives inf
    (ROADMAP.md, F20): such a batch runs `_forward_sum_scan`, that forward
    step for step."""
    logp = F.pad(wide(attn_logprob), (1, 0), value=blank_logprob)[:, 0]  # [B, T_de, T_en + 1]
    logp = F.log_softmax(torch.clamp(logp, min=_NEG), dim=-1)
    in_lens, out_lens = in_lens.long(), out_lens.long()
    if bool((in_lens > out_lens).any()):
        total = _forward_sum_scan(logp, in_lens, out_lens)
        return -torch.mean(total / out_lens.to(total.dtype))
    B, T_en = logp.shape[0], logp.shape[2] - 1
    targets = torch.arange(1, T_en + 1, device=logp.device).expand(B, T_en)
    nll = F.ctc_loss(logp.transpose(0, 1), targets, out_lens, in_lens, blank=0, reduction="none")
    return torch.mean(nll / out_lens.to(nll.dtype))


def _logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """JAX's logsumexp: the max held out of the gradient, so that equal
    entries at −1e30 share the gradient as JAX's do."""
    m = x.max(dim=dim, keepdim=True).values.detach()
    return (torch.log(torch.sum(torch.exp(x - m), dim=dim, keepdim=True)) + m).squeeze(dim)


def _forward_sum_scan(logp, in_lens, out_lens) -> torch.Tensor:
    """`tpu_tts`'s CTC forward over blank + tokens 1..T_en (`lax.scan` over
    the frames, a Python loop here): log(p) of each row's path `[B]`, the
    states started at −1e30, each row frozen after its out_len frames."""
    B, T_de, n = logp.shape
    S = 2 * (n - 1) + 1
    s_idx = torch.arange(S, device=logp.device)
    emit = logp[:, :, torch.where(s_idx % 2 == 1, (s_idx + 1) // 2, torch.zeros_like(s_idx))]  # [B, T_de, S]
    alpha = torch.cat([emit[:, 0, :2], torch.full((B, S - 2), _NEG, dtype=logp.dtype, device=logp.device)], dim=1)
    odd = (s_idx % 2 == 1)[None, :]
    for t in range(1, T_de):
        prev1 = F.pad(alpha[:, :-1], (1, 0), value=_NEG)
        prev2 = torch.where(odd, F.pad(alpha[:, :-2], (2, 0), value=_NEG), torch.full_like(alpha, _NEG))
        new = _logsumexp(torch.stack([alpha, prev1, prev2]), 0) + emit[:, t]
        alpha = torch.where((t < out_lens)[:, None], new, alpha)
    return _logaddexp(alpha.gather(1, (2 * in_lens)[:, None])[:, 0], alpha.gather(1, (2 * in_lens - 1)[:, None])[:, 0])


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(e^a + e^b) with JAX's gradient rule, e^(x − out) for each input x:
    at a = b = −1e30 the log 2 is lost to rounding and each input gets 1."""
    out = torch.logaddexp(a, b).detach()
    return out + sum(torch.exp(x.detach() - out) * (x - x.detach()) for x in (a, b))
