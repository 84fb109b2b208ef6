"""VITS losses, in float32.

Counterparts of `tpu_tts/layers/losses.py` (`kl_loss`:67, `feature_loss`
:209, `generator_loss`:220, `discriminator_loss`:228). The port's tensors
are channels-first; every loss here is a sum or mean, so the layout does not
change it.
"""

import torch


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
