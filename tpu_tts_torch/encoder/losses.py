"""Speaker-encoder losses: GE2E, angular prototypical, softmax and softmax +
angular prototypical.

Counterpart of `tpu_tts/encoder/losses.py` (`ge2e_loss`:19,
`angle_proto_loss`:39, `softmax_loss`:51, `softmax_angle_proto_loss`:57).
d-vectors are `[num_speakers, num_utter, dim]`; (w, b) are the learned
scalars of the similarity scale.
"""

import torch
import torch.nn.functional as F


def _cosine(a, b, eps: float = 1e-8):
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=eps)
    b = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True), min=eps)
    return torch.sum(a * b, dim=-1)


def ge2e_loss(dvecs, w, b):
    """GE2E softmax loss: each utterance against every speaker's centroid,
    its own speaker's centroid taken without it."""
    S, U, _ = dvecs.shape
    centroids = dvecs.mean(dim=1)  # [S, D]
    excl = (dvecs.sum(dim=1, keepdim=True) - dvecs) / (U - 1)  # [S, U, D]
    cs = _cosine(dvecs[:, :, None, :], centroids[None, None, :, :])  # [S, U, S]
    own = _cosine(dvecs, excl)  # [S, U]
    eye = torch.eye(S, dtype=torch.bool, device=dvecs.device)[:, None, :]
    sim = torch.abs(w) * torch.where(eye, own[:, :, None], cs) + b
    logp = F.log_softmax(sim, dim=-1)
    return -torch.mean(torch.diagonal(logp, dim1=0, dim2=2))


def angle_proto_loss(dvecs, w, b):
    """Angular prototypical loss: the last utterance of each speaker is the
    query, the mean of the others the anchor; |w| is clamped at 1e-6."""
    anchor = dvecs[:, :-1].mean(dim=1)  # [S, D]
    query = dvecs[:, -1]  # [S, D]
    cs = _cosine(query[:, None, :], anchor[None, :, :])  # [S, S]
    logp = F.log_softmax(torch.clamp(torch.abs(w), min=1e-6) * cs + b, dim=-1)
    return -torch.mean(torch.diagonal(logp))


def softmax_loss(logits, labels):
    return -torch.mean(torch.gather(F.log_softmax(logits, dim=-1), -1, labels[:, None].long()))


def softmax_angle_proto_loss(dvecs, w, b, logits, labels):
    return angle_proto_loss(dvecs, w, b) + softmax_loss(logits, labels)
