"""VITS building blocks, channels-first.

Counterparts of `tpu_tts/layers/vits.py`: the rational-quadratic spline
(`rational_quadratic_spline`:38, `piecewise_rational_quadratic_transform`
:128), the stochastic duration predictor's modules (`DilatedDepthSeparable
Conv`:166, `ElementwiseAffine`:200, `ConvFlow`:214, `StochasticDuration
Predictor`:254), `VitsTextEncoder`:339, `VitsPosteriorEncoder`:384,
`ResidualCouplingLayer`:418, `ResidualCouplingBlocks`:462,
`paired_disc_apply`:502 and `VitsDiscriminator`:519. The flows run in both
directions: `forward` (training: the posterior's z through the flow, the
SDP's negative log-likelihood, each with its log-determinant) and `reverse`
(sampling). Dropout acts in `train()` mode only, as the JAX modules' under
`train=True`.

The spline's public functions keep the JAX layout: the bin dimension last.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_tts_torch.layers.common import WN, LayerNorm, project
from tpu_tts_torch.layers.transformer import RelativePositionTransformer
from tpu_tts_torch.ops.helpers import sequence_mask

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _searchsorted(bin_locations, inputs, eps=1e-6):
    bin_locations = torch.cat([bin_locations[..., :-1], bin_locations[..., -1:] + eps], dim=-1)
    return torch.sum(inputs[..., None] >= bin_locations, dim=-1) - 1


def _cum_bins(unnormalized, lo, hi, min_size):
    """Softmax bin sizes → edges pinned to [lo, hi] and the sizes between them."""
    num_bins = unnormalized.shape[-1]
    sizes = min_size + (1 - min_size * num_bins) * torch.softmax(unnormalized, dim=-1)
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (hi - lo) * cum + lo
    cum = torch.cat([torch.full_like(cum[..., :1], lo), cum[..., 1:-1], torch.full_like(cum[..., :1], hi)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(
    inputs,
    unnormalized_widths,
    unnormalized_heights,
    unnormalized_derivatives,
    inverse=False,
    left=0.0,
    right=1.0,
    bottom=0.0,
    top=1.0,
    min_bin_width=DEFAULT_MIN_BIN_WIDTH,
    min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
    min_derivative=DEFAULT_MIN_DERIVATIVE,
):
    num_bins = unnormalized_widths.shape[-1]
    cumwidths, widths = _cum_bins(unnormalized_widths, left, right, min_bin_width)
    cumheights, heights = _cum_bins(unnormalized_heights, bottom, top, min_bin_height)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, inputs)[..., None]
    bin_idx = bin_idx.clamp(0, num_bins - 1)

    def take(x):
        return torch.gather(x, -1, bin_idx)[..., 0]

    input_cumwidths = take(cumwidths)
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights)
    input_delta = take(heights / widths)
    input_derivatives = take(derivatives)
    input_derivatives_plus_one = take(derivatives[..., 1:])
    input_heights = take(heights)
    slope_sum = input_derivatives + input_derivatives_plus_one - 2 * input_delta

    if inverse:
        a = (inputs - input_cumheights) * slope_sum + input_heights * (input_delta - input_derivatives)
        b = input_heights * input_derivatives - (inputs - input_cumheights) * slope_sum
        c = -input_delta * (inputs - input_cumheights)
        discriminant = torch.clamp(b**2 - 4 * a * c, min=0.0)
        root = (2 * c) / (-b - torch.sqrt(discriminant) - 1e-12)
        outputs = root * input_bin_widths + input_cumwidths
        theta_one_minus_theta = root * (1 - root)
        denominator = input_delta + slope_sum * theta_one_minus_theta
        derivative_numerator = input_delta**2 * (
            input_derivatives_plus_one * root**2
            + 2 * input_delta * theta_one_minus_theta
            + input_derivatives * (1 - root) ** 2
        )
        logabsdet = torch.log(torch.clamp(derivative_numerator, min=1e-12)) - 2 * torch.log(
            torch.clamp(denominator, min=1e-12)
        )
        return outputs, -logabsdet

    theta = (inputs - input_cumwidths) / torch.clamp(input_bin_widths, min=1e-12)
    theta_one_minus_theta = theta * (1 - theta)
    numerator = input_heights * (input_delta * theta**2 + input_derivatives * theta_one_minus_theta)
    denominator = input_delta + slope_sum * theta_one_minus_theta
    outputs = input_cumheights + numerator / torch.clamp(denominator, min=1e-12)
    derivative_numerator = input_delta**2 * (
        input_derivatives_plus_one * theta**2
        + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - theta) ** 2
    )
    logabsdet = torch.log(torch.clamp(derivative_numerator, min=1e-12)) - 2 * torch.log(
        torch.clamp(denominator, min=1e-12)
    )
    return outputs, logabsdet


def piecewise_rational_quadratic_transform(
    inputs,
    unnormalized_widths,
    unnormalized_heights,
    unnormalized_derivatives,
    inverse=False,
    tail_bound=5.0,
    min_derivative=DEFAULT_MIN_DERIVATIVE,
):
    """'linear' tails: identity outside [-B, B], spline inside."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.exp(1 - min_derivative) - 1)
    ud = F.pad(unnormalized_derivatives, (1, 1), value=constant)
    out_spline, logdet_spline = rational_quadratic_spline(
        torch.clamp(inputs, -tail_bound, tail_bound),
        unnormalized_widths,
        unnormalized_heights,
        ud,
        inverse=inverse,
        left=-tail_bound,
        right=tail_bound,
        bottom=-tail_bound,
        top=tail_bound,
    )
    outputs = torch.where(inside, out_spline, inputs)
    logabsdet = torch.where(inside, logdet_spline, torch.zeros_like(logdet_spline))
    return outputs, logabsdet


class DilatedDepthSeparableConv(nn.Module):
    """[depthwise dilated conv → LN → gelu → 1×1 → LN → gelu] residual stack."""

    def __init__(self, channels: int, kernel_size: int, num_layers: int, dropout_p: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.drop = nn.Dropout(dropout_p)
        self.convs_sep = nn.ModuleList()
        for i in range(num_layers):
            dilation = kernel_size**i
            pad = (kernel_size * dilation - dilation) // 2
            self.convs_sep.append(
                nn.Conv1d(channels, channels, kernel_size, groups=channels, dilation=dilation, padding=pad)
            )
        self.convs_1x1 = nn.ModuleList(nn.Conv1d(channels, channels, 1) for _ in range(num_layers))
        self.norms_1 = nn.ModuleList(LayerNorm(channels) for _ in range(num_layers))
        self.norms_2 = nn.ModuleList(LayerNorm(channels) for _ in range(num_layers))

    def forward(self, x, x_mask, g=None):
        if g is not None:
            x = x + g
        for i in range(self.num_layers):
            y = F.gelu(self.norms_1[i](self.convs_sep[i](x * x_mask)))
            y = F.gelu(self.norms_2[i](self.convs_1x1[i](y)))
            x = x + self.drop(y)
        return x * x_mask


class ElementwiseAffine(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.translation = nn.Parameter(torch.zeros(channels, 1))
        self.log_scale = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x, x_mask, g=None):
        """→ (y, logdet `[B]`)."""
        y = (x * torch.exp(self.log_scale) + self.translation) * x_mask
        return y, torch.sum(self.log_scale * x_mask, dim=(1, 2))

    def reverse(self, x, x_mask, g=None):
        return (x - self.translation) * torch.exp(-self.log_scale) * x_mask


class ConvFlow(nn.Module):
    """Half-split coupling with a spline transform."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int, num_layers: int,
                 num_bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        self.half = in_channels // 2
        self.hidden_channels = hidden_channels
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.pre = nn.Conv1d(self.half, hidden_channels, 1)
        self.convs = DilatedDepthSeparableConv(hidden_channels, kernel_size, num_layers)
        self.proj = nn.Conv1d(hidden_channels, self.half * (num_bins * 3 - 1), 1)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def _transform(self, x, x_mask, g, inverse: bool):
        x0, x1 = x[:, : self.half], x[:, self.half :]
        h = self.convs(self.pre(x0), x_mask, g=g)
        h = self.proj(h) * x_mask
        B, _, T = x0.shape
        h = h.reshape(B, self.half, 3 * self.num_bins - 1, T).permute(0, 1, 3, 2)  # [B, half, T, 3n-1]
        scale = 1.0 / math.sqrt(self.hidden_channels)
        uw = h[..., : self.num_bins] * scale
        uh = h[..., self.num_bins : 2 * self.num_bins] * scale
        ud = h[..., 2 * self.num_bins :]
        x1, logabsdet = piecewise_rational_quadratic_transform(x1, uw, uh, ud, inverse=inverse,
                                                               tail_bound=self.tail_bound)
        return torch.cat([x0, x1], dim=1) * x_mask, logabsdet

    def forward(self, x, x_mask, g=None):
        """→ (y, logdet `[B]`)."""
        y, logabsdet = self._transform(x, x_mask, g, inverse=False)
        return y, torch.sum(logabsdet * x_mask, dim=(1, 2))

    def reverse(self, x, x_mask, g=None):
        return self._transform(x, x_mask, g, inverse=True)[0]


class StochasticDurationPredictor(nn.Module):
    """Spline-flow duration predictor. `forward` is training's negative
    log-likelihood of the aligned durations through the posterior flows
    (`post_*`) and the main flows; `reverse` samples log durations. With
    `cond_channels` / `language_emb_dim`, 1×1 projections of g and the
    language embedding are added after `pre` (`tpu_tts/layers/vits.py`
    :263-288)."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int, num_flows: int = 4,
                 cond_channels: int = 0, language_emb_dim: int = 0, dropout_p: float = 0.0):
        super().__init__()
        self.pre = nn.Conv1d(in_channels, hidden_channels, 1)
        self.convs = DilatedDepthSeparableConv(hidden_channels, kernel_size, 3, dropout_p)
        self.proj = nn.Conv1d(hidden_channels, hidden_channels, 1)
        self.flows = nn.ModuleList(
            [ElementwiseAffine(2)] + [ConvFlow(2, hidden_channels, kernel_size, 3) for _ in range(num_flows)]
        )
        self.post_pre = nn.Conv1d(1, hidden_channels, 1)
        self.post_convs = DilatedDepthSeparableConv(hidden_channels, kernel_size, 3, dropout_p)
        self.post_proj = nn.Conv1d(hidden_channels, hidden_channels, 1)
        self.post_flows = nn.ModuleList(
            [ElementwiseAffine(2)] + [ConvFlow(2, hidden_channels, kernel_size, 3) for _ in range(num_flows)]
        )
        if cond_channels:
            self.cond = nn.Conv1d(cond_channels, hidden_channels, 1)
        if language_emb_dim:
            self.cond_lang = nn.Conv1d(language_emb_dim, hidden_channels, 1)

    def _condition(self, x, x_mask, g, lang_emb):
        x = self.pre(x)
        if g is not None:
            x = x + self.cond(g)
        if lang_emb is not None:
            x = x + self.cond_lang(lang_emb)
        x = self.convs(x, x_mask)
        return self.proj(x) * x_mask

    def forward(self, x, x_mask, dr, noise: torch.Tensor, g=None, lang_emb=None):
        """Negative log-likelihood `[B]` of the durations dr `[B, 1, T]`
        (MAS's frame counts) given x `[B, C, T]`; noise `[B, 2, T]` is the
        posterior's standard-normal draw."""
        x = self._condition(x, x_mask, g, lang_emb)
        h = self.post_proj(self.post_convs(self.post_pre(dr), x_mask)) * x_mask
        noise = noise * x_mask
        z_q, logdet_tot_q = noise, 0.0
        for idx, flow in enumerate(self.post_flows):
            z_q, logdet_q = flow(z_q, x_mask, g=x + h)
            logdet_tot_q = logdet_tot_q + logdet_q
            if idx > 0:
                z_q = torch.flip(z_q, [1])
        z_u, z_v = z_q[:, :1], z_q[:, 1:]
        u = torch.sigmoid(z_u) * x_mask
        z0 = (dr - u) * x_mask
        logdet_tot_q = logdet_tot_q + torch.sum((F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, dim=(1, 2))
        nll_posterior = torch.sum(-0.5 * (math.log(2 * math.pi) + noise**2) * x_mask, dim=(1, 2)) - logdet_tot_q
        z0 = torch.log(torch.clamp(z0, min=1e-5)) * x_mask
        logdet_tot = torch.sum(-z0, dim=(1, 2))
        z = torch.cat([z0, z_v], dim=1)
        for idx, flow in enumerate(self.flows):
            z, logdet = flow(z, x_mask, g=x)
            logdet_tot = logdet_tot + logdet
            if idx > 0:
                z = torch.flip(z, [1])
        nll_flow = torch.sum(0.5 * (math.log(2 * math.pi) + z**2) * x_mask, dim=(1, 2)) - logdet_tot
        return nll_flow + nll_posterior

    def reverse(self, x, x_mask, noise: torch.Tensor, noise_scale: float = 1.0, g=None, lang_emb=None):
        """x `[B, C, T]`, noise `[B, 2, T]` standard normal, g and lang_emb
        `[B, C_*, 1]` or None → logw `[B, 1, T]`."""
        x = self._condition(x, x_mask, g, lang_emb)
        flows = list(reversed(self.flows))
        flows = flows[:-2] + [flows[-1]]  # drop the unused extra flow
        z = noise * noise_scale
        for flow in flows:
            z = torch.flip(z, [1])
            z = flow.reverse(z, x_mask, g=x)
        return z[:, :1]


class VitsTextEncoder(nn.Module):
    """Embedding → rel-pos transformer → (h, m, logs, x_mask). With
    `language_emb_dim` the language embedding is concatenated to each token's
    embedding, and the transformer and `proj` run at hidden + language
    channels (`tpu_tts/layers/vits.py`:350-367)."""

    def __init__(self, n_vocab: int, out_channels: int, hidden_channels: int, hidden_channels_ffn: int,
                 num_heads: int, num_layers: int, kernel_size: int, language_emb_dim: int = 0,
                 dropout_p: float = 0.0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.out_channels = out_channels
        self.emb = nn.Embedding(n_vocab, hidden_channels)
        nn.init.normal_(self.emb.weight, 0.0, hidden_channels**-0.5)
        width = hidden_channels + language_emb_dim
        self.encoder = RelativePositionTransformer(
            width, hidden_channels_ffn, num_heads, num_layers, kernel_size, rel_attn_window_size=4,
            dropout_p=dropout_p
        )
        self.proj = nn.Conv1d(width, out_channels * 2, 1)

    def forward(self, x, x_lengths, lang_emb=None):
        """x `[B, T]` token ids, x_lengths `[B]`, lang_emb `[B, C_l, 1]` or None."""
        h = (self.emb(x) * math.sqrt(self.hidden_channels)).transpose(1, 2)  # [B, C, T]
        if lang_emb is not None:
            h = torch.cat([h, lang_emb.expand(-1, -1, h.shape[2])], dim=1)
        x_mask = sequence_mask(x_lengths, x.shape[1]).to(h.dtype)[:, None, :]
        h = self.encoder(h * x_mask, x_mask)
        stats = self.proj(h) * x_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        return h, m, logs, x_mask


class VitsPosteriorEncoder(nn.Module):
    """Linear spectrogram → (z, m_q, logs_q, y_mask): 1×1 `pre`, a WN stack
    (conditioned on g `[B, C_g, 1]` when `cond_channels`), 1×1 `proj` to the
    posterior's mean and log-scale, and the sample z = m + ε·exp(logs)."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, num_layers: int, cond_channels: int = 0):
        super().__init__()
        self.compute_dtype = None
        self.out_channels = out_channels
        self.pre = nn.Conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, num_layers, cond_channels)
        self.proj = nn.Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x, x_lengths, noise: torch.Tensor, g=None):
        """x `[B, C_spec, T]`, x_lengths `[B]`, noise `[B, C_out, T]` the
        standard-normal ε. With a compute dtype, `pre` and the WN compute in
        it and the statistics leave in float32 (`tpu_tts/layers/vits.py`:
        394-411)."""
        x_mask = sequence_mask(x_lengths, x.shape[2]).to(x.dtype)[:, None, :]
        h = self.enc(project(self.pre, x, self.compute_dtype) * x_mask, x_mask, g=g)
        stats = self.proj(h) * x_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        z = (m + noise * torch.exp(logs)) * x_mask
        return z, m, logs, x_mask


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling with a WN core; with a compute dtype, `pre`
    and the WN compute in it and `post` in float32."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int, dilation_rate: int, num_layers: int,
                 cond_channels: int = 0):
        super().__init__()
        self.compute_dtype = None
        self.half = channels // 2
        self.pre = nn.Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, num_layers, cond_channels)
        self.post = nn.Conv1d(hidden_channels, self.half, 1)
        nn.init.zeros_(self.post.weight)
        nn.init.zeros_(self.post.bias)

    def _mean(self, x0, x_mask, g):
        return self.post(self.enc(project(self.pre, x0, self.compute_dtype) * x_mask, x_mask, g=g)) * x_mask

    def forward(self, x, x_mask, g=None):
        """Mean-only, so its log-determinant is 0."""
        x0, x1 = x[:, : self.half], x[:, self.half :]
        return torch.cat([x0, (self._mean(x0, x_mask, g) + x1) * x_mask], dim=1)

    def reverse(self, x, x_mask, g=None):
        x0, x1 = x[:, : self.half], x[:, self.half :]
        return torch.cat([x0, (x1 - self._mean(x0, x_mask, g)) * x_mask], dim=1)


class ResidualCouplingBlocks(nn.Module):
    """num_flows × [coupling, flip]; flips carry no parameters. g
    `[B, C_g, 1]` conditions every coupling's WN."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int, dilation_rate: int, num_layers: int,
                 num_flows: int = 4, cond_channels: int = 0):
        super().__init__()
        self.flows = nn.ModuleList(
            ResidualCouplingLayer(channels, hidden_channels, kernel_size, dilation_rate, num_layers, cond_channels)
            for _ in range(num_flows)
        )

    def forward(self, x, x_mask, g=None):
        for layer in self.flows:
            x = torch.flip(layer(x, x_mask, g=g), [1])
        return x

    def reverse(self, x, x_mask, g=None):
        for layer in reversed(self.flows):
            x = layer.reverse(torch.flip(x, [1]), x_mask, g=g)
        return x


def paired_disc_apply(disc, real, fake):
    """One discriminator pass over [real; fake] stacked on the batch axis,
    split back into (scores_real, scores_fake, feats_real, feats_fake); each
    row's outputs equal a pass of its own."""
    B = real.shape[0]
    scores, feats = disc(torch.cat([real, fake], dim=0))
    return ([s[:B] for s in scores], [s[B:] for s in scores], [[f[:B] for f in fl] for fl in feats],
            [[f[B:] for f in fl] for fl in feats])


class VitsDiscriminator(nn.Module):
    """The scale discriminator (`nets.0`, VITS's slim schedule) and one period
    discriminator per period (`nets.1…`), Coqui's module names. x `[B, 1, T]`
    → (scores, features), one entry per discriminator."""

    def __init__(self, periods=(2, 3, 5, 7, 11), use_spectral_norm: bool = False):
        super().__init__()
        from tpu_tts_torch.vocoder.models.hifigan_discriminator import DiscriminatorP, DiscriminatorS

        self.nets = nn.ModuleList([DiscriminatorS(use_spectral_norm=use_spectral_norm)])
        self.nets.extend(DiscriminatorP(p, use_spectral_norm=use_spectral_norm) for p in periods)

    def forward(self, x):
        scores, feats = [], []
        for net in self.nets:
            score, feat = net(x)
            scores.append(score)
            feats.append(feat)
        return scores, feats
