"""Speaker (d-vector) encoders: the LSTM and the SE-ResNet with attentive pooling.

Counterpart of `tpu_tts/encoder/models.py` (`LSTMSpeakerEncoder`:19,
`SELayer`:44, `_Norm2d`:57, `SEBasicBlock`:81, `ResNetSpeakerEncoder`:107,
`SpeakerEncoderModel`:163, `setup_encoder_model`:288). The modules take a
log-mel `[B, C_mel, T]` and keep Coqui's layout and names
(`TTS/encoder/models/{lstm,resnet}.py`), so a Coqui `.pth` loads by name:

- the LSTM: `layers.{i}.lstm` (torch's gate order i, f, g, o, which flax's
  `OptimizedLSTMCell` shares) and `layers.{i}.linear`, whose bias the JAX
  model has and Coqui's lacks (a Coqui checkpoint loads it as 0);
- the ResNet reads the mel as a `[B, 1, F, T]` image, frequency the height,
  and flattens its last map channel-major, `[B, C·F', T']`, as Coqui does;
  the JAX model reads `[B, T, F, 1]` and flattens frequency-major, and its
  converter permutes the attention and `fc` rows to match, so the two
  compute the same function. The SE block keeps the reference's relu
  before `bn1` (`:94-96`); the attentive pooling's variance is clamped at
  1e-5 (`:153`), the input instance norm uses eps 1e-5 (`:122-125`).

`norm_type` is `_Norm2d`'s (`layers/norms.py`): "batch" is `nn.BatchNorm` (torch's momentum
0.1 and unbiased running variance, `TorchBatchNorm`'s), normalising by the
batch in `train()` mode; "frozen_batch" always normalises by its running
statistics (a Coqui checkpoint's, `FrozenBatchNorm`), and takes no
gradient for them; "layer" is a LayerNorm over channels (eps 1e-6, flax's).
The LSTM and the ResNet ignore Coqui's `use_torch_spec` and `log_input`:
the mel comes from `SpeakerEncoderModel.features_from_wav` (centred log-mels
at the encoder's audio settings), as in JAX, which also ignores the
config's `preemphasis`.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.audio import torch_transforms as tt
from tpu_tts_torch.device import resolve_device
from tpu_tts_torch.layers.norms import make_norm


def _instance_norm(x):
    """Per-channel normalisation over time of `[B, C, T]`, eps 1e-5."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def _l2(d):
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)


class LSTMWithProjection(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, proj_size: int):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, batch_first=True)
        self.linear = nn.Linear(hidden_size, proj_size)

    def forward(self, x):
        return self.linear(self.lstm(x)[0])


class LSTMSpeakerEncoder(nn.Module):
    """Instance-normalised mel → `num_lstm_layers` × (LSTM, projection) → the
    last frame's projection, L2-normalised with `l2_norm`."""

    def __init__(self, input_dim: int = 80, proj_dim: int = 256, lstm_dim: int = 768, num_lstm_layers: int = 3):
        super().__init__()
        self.layers = nn.Sequential(*(LSTMWithProjection(input_dim if i == 0 else proj_dim, lstm_dim, proj_dim)
                                      for i in range(num_lstm_layers)))

    def forward(self, x, l2_norm: bool = True):
        """x `[B, C_mel, T]` → `[B, proj_dim]`."""
        d = self.layers(_instance_norm(x).transpose(1, 2))[:, -1]
        return _l2(d) if l2_norm else d


class SELayer(nn.Module):
    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc = nn.Sequential(nn.Linear(channels, hidden), nn.ReLU(inplace=True), nn.Linear(hidden, channels),
                                nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class SEBasicBlock(nn.Module):
    """conv1 → relu → bn1 → conv2 → bn2 → SE, plus the residual (a strided
    1×1 conv and a norm when the shape changes), then relu."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, norm_type: str = "batch"):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = make_norm(norm_type, planes, dims=2)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = make_norm(norm_type, planes, dims=2)
        self.se = SELayer(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                                            make_norm(norm_type, planes, dims=2))

    def forward(self, x):
        y = self.bn1(F.relu(self.conv1(x)))
        y = self.se(self.bn2(self.conv2(y)))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNetSpeakerEncoder(nn.Module):
    """SE-ResNet over the mel image with attentive statistics (ASP) or mean
    (SAP) pooling → `fc` → `[B, proj_dim]`."""

    def __init__(self, input_dim: int = 64, proj_dim: int = 512, layers=(3, 4, 6, 3), num_filters=(32, 64, 128, 256),
                 encoder_type: str = "ASP", norm_type: str = "layer"):
        super().__init__()
        self.input_dim, self.proj_dim = input_dim, proj_dim
        self.layers, self.num_filters = tuple(layers), tuple(num_filters)
        self.encoder_type, self.norm_type = encoder_type, norm_type
        self.conv1 = nn.Conv2d(1, num_filters[0], 3, padding=1)
        self.bn1 = make_norm(norm_type, num_filters[0], dims=2)
        inplanes = num_filters[0]
        for li, (n_blocks, planes) in enumerate(zip(layers, num_filters)):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(SEBasicBlock(inplanes, planes, stride=(1 if li == 0 or bi else 2), norm_type=norm_type))
                inplanes = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        width = num_filters[-1] * (input_dim // 8)
        self.attention = nn.Sequential(nn.Conv1d(width, 128, 1), nn.ReLU(), make_norm(norm_type, 128, dims=1),
                                       nn.Conv1d(128, width, 1), nn.Softmax(dim=2))
        self.fc = nn.Linear(width * (2 if encoder_type == "ASP" else 1), proj_dim)

    def forward(self, x, l2_norm: bool = True):
        """x `[B, C_mel, T]` → `[B, proj_dim]`."""
        h = self.bn1(F.relu(self.conv1(_instance_norm(x)[:, None])))
        for li in range(len(self.layers)):
            h = getattr(self, f"layer{li + 1}")(h)
        h = h.reshape(h.shape[0], -1, h.shape[-1])  # [B, C·F', T']
        w = self.attention(h)
        mu = torch.sum(h * w, dim=2)
        if self.encoder_type == "ASP":
            sg = torch.sqrt(torch.clamp(torch.sum(h * h * w, dim=2) - mu * mu, min=1e-5))
            mu = torch.cat([mu, sg], dim=1)
        d = self.fc(mu)
        return _l2(d) if l2_norm else d


def build_net(model_params: dict, norm_type: str = None) -> nn.Module:
    """The encoder `model_params` describe (`model_name` "lstm" or "resnet");
    a ResNet takes `norm_type` when given, else the params' or "batch"."""
    p = model_params or {}
    name = p.get("model_name", "lstm")
    if name == "lstm":
        return LSTMSpeakerEncoder(input_dim=p.get("input_dim", 80), proj_dim=p.get("proj_dim", 256),
                                  lstm_dim=p.get("lstm_dim", 768), num_lstm_layers=p.get("num_lstm_layers", 3))
    if name == "resnet":
        return ResNetSpeakerEncoder(input_dim=p.get("input_dim", 64), proj_dim=p.get("proj_dim", 512),
                                    norm_type=norm_type or p.get("norm_type") or "batch")
    raise ValueError(f" [!] Unknown encoder model {name}")


class SpeakerEncoderModel:
    """The encoder net with its featurisation on the device and the windowed
    embedding of a whole utterance. `net` is in `eval()` mode unless a
    trainer sets it otherwise."""

    def __init__(self, config, device=None):
        self.config = config
        self.device = resolve_device(device)
        audio = config.audio
        self.audio = dict(audio) if isinstance(audio, dict) else audio.to_dict()
        self.net = build_net(config.model_params).to(self.device).eval()

    def features_from_wav(self, wav: torch.Tensor) -> torch.Tensor:
        """`[B, T]` → centred log-mels `[B, num_mels, T_frames]`."""
        a = self.audio
        return tt.wav_to_mel(wav, fft_size=a["fft_size"], num_mels=a["num_mels"], sample_rate=a["sample_rate"],
                             hop_length=a["hop_length"], win_length=a["win_length"], fmin=a.get("mel_fmin", 0.0),
                             fmax=a.get("mel_fmax"), center=True)

    @torch.no_grad()
    def compute_embedding(self, wav, num_frames: int = 250, num_eval: int = 10) -> np.ndarray:
        """The mean embedding of `num_eval` windows of `num_frames` frames at
        `np.linspace` offsets over the utterance (one window when it is
        shorter), float32 `[proj_dim]`."""
        wav = torch.as_tensor(np.asarray(wav, dtype=np.float32), device=self.device)[None]
        feats = self.features_from_wav(wav)[0]  # [C, T]
        T = feats.shape[1]
        if T <= num_frames:
            windows = feats[None]
        else:
            offsets = np.linspace(0, T - num_frames, num=num_eval).astype(int)
            windows = torch.stack([feats[:, o : o + num_frames] for o in offsets])
        return self.net(windows).mean(dim=0).float().cpu().numpy()

    def load_checkpoint(self, config, checkpoint_path: str, eval: bool = True, strict: bool = True):
        """The port's encoder checkpoint or a Coqui `.pth` (`{"model": ...}`
        or flat). A ResNet switches to "frozen_batch" first, as `tpu_tts`
        does for a `.pth`; in `eval()` mode that is what "batch" computes."""
        from tpu_tts_torch.encoder.encoder_convert import state_dict_from_coqui
        from tpu_tts_torch.utils.checkpoint import read_checkpoint

        ckpt = read_checkpoint(checkpoint_path)
        sd = ckpt["model"] if isinstance(ckpt.get("model"), dict) else ckpt
        if isinstance(self.net, ResNetSpeakerEncoder) and self.net.norm_type != "frozen_batch":
            self.net = build_net(self.config.model_params, norm_type="frozen_batch").to(self.device)
        self.net.load_state_dict(state_dict_from_coqui(sd, self.net), strict=strict)
        self.net.train(not eval)
        return ckpt


def setup_encoder_model(config, device=None) -> SpeakerEncoderModel:
    return SpeakerEncoderModel(config, device=device)
