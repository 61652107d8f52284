"""BS-RoFormer (band-split RoPE transformer) at inference, in PyTorch.

Lu, Wang, Kong, Hung, "Music Source Separation with Band-Split RoPE
Transformer" (arXiv:2309.02612), as ``lucidrains/BS-RoFormer``'s
``bs_roformer.py`` computes it where the paper is silent:

  * a centred stereo STFT (``ops/stft.py::stft_centered``, periodic Hann
    of n_fft, hop ``stft_hop``): [B, 2, T, K] for K = n_fft / 2 + 1 bins;
  * band split: band b stacks its bins x 2 channels x (re, im) into d_b =
    4 bins_b features (bin-major, then channel, then re/im), and
    ``z_b = Linear_b(RMSNorm_b(.))`` is a token of width ``dim``;
  * ``depth`` blocks of a time-axis layer (a sequence of T frames for each
    band) and a band-axis layer (a sequence of the bands for each frame),
    each pre-norm: ``H += W_o Attn(RoPE(q), RoPE(k), v)`` with ``q, k, v =
    W_qkv RMSNorm(H)`` (``heads`` heads of ``dim_head``, no biases), then
    ``H += W_2 GELU(W_1 RMSNorm(H) + b_1) + b_2``; the rotary embedding is
    over the layer's own axis, theta 10,000, on interleaved pairs (as
    ``rotary_embedding_torch``);
  * a final RMSNorm; per band and predicted source a mask
    ``GLU(W_b2 tanh(W_b1 H_b + c_b1) + c_b2)`` of d_b values (two Linears,
    ``lucidrains``' mask-estimator depth 2, fixed here), read as
    complex numbers bin by bin and channel by channel;
  * each source is ``istft_centered(mask * X)`` at the window's length.

RMSNorm is ``x / max(||x||, 1e-12) * sqrt(d) * gamma``. The attention
gates of later ``lucidrains`` versions are left out, as the paper has
none. The model predicts the sources before the last with the difference
output (``Config.output_type``; the engine's forward adds the last,
``infer/engine.py::model_forward``), all of them with the direct one.

Parameters are the port's flat dict of the ``lucidrains`` modules (kernels
[in, out], as the other families'): ``band_split_<b>`` {gamma, kernel,
bias}; ``block_<l>/<axis>_attn`` {gamma, qkv, out} and
``block_<l>/<axis>_ff`` {gamma, kernel1, bias1, kernel2, bias2} for axis
``time`` and ``band``; ``final_norm`` {gamma}; ``mask_<source>_<b>``
{kernel1, bias1, kernel2, bias2}. ``prepare_params`` turns them, once,
into what ``forward`` reads: every Linear's weights and biases in
``Config.compute_dtype``, the per-band layers stacked a group of equal
band widths (one batched GEMM a group), the norms' gammas in fp32.

Precision with ``compute_dtype="bfloat16"``: every Linear and the
attention take bf16 operands and give bf16 results, summing in fp32
(``allow_bf16_reduced_precision_reduction`` is switched off, as cuBLAS may
otherwise reduce split sums in bf16); the residual stream, the RMSNorms,
the RoPE tables and rotation, the STFT, the GLU, the mask multiply and the
iSTFT are fp32. Attention runs through ``ops/attention.py`` (flash
attention on the card). The eager forward names its parts with the spans
``roformer.stft``, ``.band_split``, ``.time_layer``, ``.band_layer``,
``.mask`` and ``.istft`` (``tracing.py``: on only under a profiler; a CUDA
graph replay runs none of them).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from waveunet_tpu_torch import tracing
from waveunet_tpu_torch.config import Config
from waveunet_tpu_torch.device import DeviceLike, resolve_device
from waveunet_tpu_torch.ops.attention import attention
from waveunet_tpu_torch.ops.stft import istft_centered, stft_centered

Tree = Dict[str, Dict[str, torch.Tensor]]

ROPE_THETA = 10000.0
NORM_EPS = 1e-12
AXES = ("time", "band")

_ROPE: Dict[Tuple, torch.Tensor] = {}


def predicted_sources(cfg: Config) -> Tuple[str, ...]:
    """The sources the network masks: all but the last with the
    difference output."""
    names = cfg.source_names
    return names[:-1] if cfg.output_type == "difference" else names


def band_groups(cfg: Config) -> List[Tuple[int, int, int]]:
    """Runs of equal band widths in band order: (first band, bands, bins a
    band)."""
    groups: List[Tuple[int, int, int]] = []
    for b, bins in enumerate(cfg.freqs_per_bands):
        if groups and groups[-1][2] == bins:
            first, n, _ = groups[-1]
            groups[-1] = (first, n + 1, bins)
        else:
            groups.append((b, 1, bins))
    return groups


def leaf_shapes(cfg: Config) -> Dict[str, Dict[str, tuple]]:
    """{layer: {leaf: shape}} of the parameters, in layout order."""
    D, inner = cfg.dim, cfg.heads * cfg.dim_head
    hidden = cfg.ff_mult * D
    out: Dict[str, Dict[str, tuple]] = {}
    for b, bins in enumerate(cfg.freqs_per_bands):
        d = 4 * bins
        out[f"band_split_{b}"] = {"gamma": (d,), "kernel": (d, D),
                                  "bias": (D,)}
    for layer in range(cfg.depth):
        for axis in AXES:
            out[f"block_{layer}/{axis}_attn"] = {
                "gamma": (D,), "qkv": (D, 3 * inner), "out": (inner, D)}
            out[f"block_{layer}/{axis}_ff"] = {
                "gamma": (D,), "kernel1": (D, hidden), "bias1": (hidden,),
                "kernel2": (hidden, D), "bias2": (D,)}
    out["final_norm"] = {"gamma": (D,)}
    mlp = cfg.ff_mult * D  # lucidrains' mlp_expansion_factor, 4
    for source in predicted_sources(cfg):
        for b, bins in enumerate(cfg.freqs_per_bands):
            d = 4 * bins
            out[f"mask_{source}_{b}"] = {
                "kernel1": (D, mlp), "bias1": (mlp,),
                "kernel2": (mlp, 2 * d), "bias2": (2 * d,)}
    return out


def init_bs_roformer(generator: torch.Generator, cfg: Config,
                     device: DeviceLike = None) -> Tree:
    """Parameters as ``torch.nn.Linear`` and ``lucidrains``' RMSNorm start
    them: kernels and biases uniform in +-1/sqrt(fan_in), gammas 1.
    ``generator`` is a CPU ``torch.Generator``."""
    dev = resolve_device(device)
    params: Tree = {}
    kernel_of = {"bias": "kernel", "bias1": "kernel1", "bias2": "kernel2"}
    for layer, leaves in leaf_shapes(cfg).items():
        params[layer] = {}
        for leaf, shape in leaves.items():
            if leaf == "gamma":
                t = torch.ones(shape)
            else:
                fan_in = leaves[kernel_of.get(leaf, leaf)][0]
                t = (torch.rand(shape, generator=generator) * 2 - 1) \
                    / math.sqrt(fan_in)
            params[layer][leaf] = t.to(dev)
    return params


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def prepare_params(params: Tree, cfg: Config) -> Tree:
    """What ``forward`` reads (module docstring), made once from the flat
    dict: casts, transposes to [out, in] for ``F.linear``, and the
    per-band layers stacked a group of equal widths ([bands, in, out]
    kernels, [bands, 1, out] biases, [bands, d] gammas)."""
    dt = compute_dtype(cfg)
    if dt == torch.bfloat16:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False

    def lin(t):
        return t.t().contiguous().to(dt)

    out: Tree = {}
    for layer in range(cfg.depth):
        for axis in AXES:
            a = params[f"block_{layer}/{axis}_attn"]
            f = params[f"block_{layer}/{axis}_ff"]
            out[f"block_{layer}/{axis}"] = {
                "attn_gamma": a["gamma"].float(), "qkv": lin(a["qkv"]),
                "out": lin(a["out"]), "ff_gamma": f["gamma"].float(),
                "kernel1": lin(f["kernel1"]), "bias1": f["bias1"].to(dt),
                "kernel2": lin(f["kernel2"]), "bias2": f["bias2"].to(dt)}
    out["final_norm"] = {"gamma": params["final_norm"]["gamma"].float()}
    for j, (first, n, _) in enumerate(band_groups(cfg)):
        bands = range(first, first + n)
        split = [params[f"band_split_{b}"] for b in bands]
        out[f"band_split/g{j}"] = {
            "gamma": torch.stack([p["gamma"] for p in split]).float(),
            "kernel": torch.stack([p["kernel"] for p in split]).to(dt),
            "bias": torch.stack([p["bias"] for p in split])[:, None].to(dt)}
        for source in predicted_sources(cfg):
            m = [params[f"mask_{source}_{b}"] for b in bands]
            out[f"mask_{source}/g{j}"] = {
                k: (torch.stack([p[k] for p in m]) if k.startswith("kernel")
                    else torch.stack([p[k] for p in m])[:, None]).to(dt)
                for k in ("kernel1", "bias1", "kernel2", "bias2")}
    return out


def rms_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """x / max(||x||, eps) * sqrt(d) * gamma over the last axis, in fp32:
    ``F.rms_norm``'s x * rsqrt(mean(x^2) + eps') * gamma is the same with
    eps' = eps^2 / d. ``gamma`` is [d], or [bands, d] for x [M, bands,
    d]."""
    d = x.shape[-1]
    if gamma.dim() == 1:
        return F.rms_norm(x.float(), (d,), gamma, NORM_EPS ** 2 / d)
    return F.rms_norm(x.float(), (d,), None, NORM_EPS ** 2 / d) * gamma


def rope_table(n: int, dim_head: int, device: torch.device) -> torch.Tensor:
    """complex64 [n, dim_head / 2]: exp(i pos theta^(-2j/dim_head)) for
    positions 0..n-1, the angles in fp32 as ``rotary_embedding_torch``
    makes them; cached per device, so a CUDA-graph capture copies nothing
    from the host."""
    key = (n, dim_head, str(device))
    table = _ROPE.get(key)
    if table is None:
        freqs = 1.0 / (ROPE_THETA ** (torch.arange(
            0, dim_head, 2, device=device).float() / dim_head))
        angles = torch.arange(n, device=device).float()[:, None] * freqs
        table = _ROPE[key] = torch.polar(torch.ones_like(angles), angles)
    return table


def rope(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rotate [batch, S, ..., d] by the positions of its S axis, in fp32:
    pair (x_2i, x_2i+1), read as x_2i + i x_2i+1, times pair i's entry of
    ``table`` [S, d / 2]."""
    x = x.to(torch.float32, memory_format=torch.contiguous_format)
    z = torch.view_as_complex(x.unflatten(-1, (-1, 2)))
    z = z * table.view((table.shape[0],) + (1,) * (z.dim() - 3)
                       + table.shape[1:])
    return torch.view_as_real(z).flatten(-2)


def transformer_layer(p: Dict[str, torch.Tensor], h: torch.Tensor,
                      cfg: Config) -> torch.Tensor:
    """One pre-norm attention + feed-forward layer over [batch, S, dim]
    fp32 tokens, attending along S; ``h`` is updated in place."""
    dt = compute_dtype(cfg)
    nb, S, _ = h.shape
    H, dh = cfg.heads, cfg.dim_head
    a = rms_norm(h, p["attn_gamma"]).to(dt)
    qkv = F.linear(a, p["qkv"]).view(nb, S, 3, H, dh)
    qk = rope(qkv[:, :, :2], rope_table(S, dh, h.device)).to(dt)
    q, k = qk[:, :, 0].transpose(1, 2), qk[:, :, 1].transpose(1, 2)
    v = qkv[:, :, 2].transpose(1, 2)
    o = attention(q, k, v).transpose(1, 2).reshape(nb, S, H * dh)
    h.add_(F.linear(o, p["out"]))
    f = rms_norm(h, p["ff_gamma"]).to(dt)
    f = F.gelu(F.linear(f, p["kernel1"], p["bias1"]))
    return h.add_(F.linear(f, p["kernel2"], p["bias2"]))


def band_split(p: Tree, cfg: Config, feats: torch.Tensor) -> torch.Tensor:
    """[B, T, 4K] fp32 features -> [B, T, bands, dim] fp32 tokens: each
    group's RMSNorms, then one batched GEMM a group."""
    dt = compute_dtype(cfg)
    B, T, _ = feats.shape
    M, off, outs = B * T, 0, []
    for j, (_, n, bins) in enumerate(band_groups(cfg)):
        g = p[f"band_split/g{j}"]
        d = 4 * bins
        x = feats[:, :, off:off + n * d].reshape(M, n, d)
        x = rms_norm(x, g["gamma"]).to(dt).transpose(0, 1)   # [n, M, d]
        outs.append(torch.baddbmm(g["bias"], x, g["kernel"]))
        off += n * d
    z = torch.cat(outs).transpose(0, 1)                      # [M, bands, D]
    return z.to(torch.float32, memory_format=torch.contiguous_format).view(
        B, T, len(cfg.freqs_per_bands), cfg.dim)


def mask_estimate(p: Tree, cfg: Config, source: str,
                  h: torch.Tensor) -> torch.Tensor:
    """[bands, M, dim] normed tokens (compute dtype) -> [M, 4K] fp32 mask
    values, band by band in feature order: per group one batched GEMM,
    tanh, another, and the GLU in fp32."""
    M = h.shape[1]
    outs = []
    for j, (first, n, _) in enumerate(band_groups(cfg)):
        g = p[f"mask_{source}/g{j}"]
        z = torch.tanh(torch.baddbmm(g["bias1"], h[first:first + n],
                                     g["kernel1"]))
        m = torch.baddbmm(g["bias2"], z, g["kernel2"]).float()
        a, gate = m.chunk(2, dim=-1)
        outs.append((a * torch.sigmoid(gate)).transpose(0, 1).reshape(M, -1))
    return torch.cat(outs, dim=1)


def forward(p: Tree, cfg: Config, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[B, N, 2] fp32 windows -> {source: [B, N, 2] fp32} for the predicted
    sources, from ``prepare_params``' parameters."""
    B, N, C = x.shape
    n_fft, hop = cfg.stft_n_fft, cfg.stft_hop
    bands = len(cfg.freqs_per_bands)
    with tracing.span("roformer.stft"):
        spec = stft_centered(x.transpose(1, 2), n_fft, hop)  # [B, C, T, K]
        T, K = spec.shape[-2:]
        feats = torch.view_as_real(spec).permute(0, 2, 3, 1, 4).reshape(
            B, T, K * C * 2)
    with tracing.span("roformer.band_split"):
        h = band_split(p, cfg, feats)                          # [B, T, F, D]
    D = cfg.dim
    for layer in range(cfg.depth):
        with tracing.span("roformer.time_layer"):
            h = h.transpose(1, 2).reshape(B * bands, T, D)
            h = transformer_layer(p[f"block_{layer}/time"], h, cfg)
        with tracing.span("roformer.band_layer"):
            h = h.view(B, bands, T, D).transpose(1, 2).reshape(
                B * T, bands, D)
            h = transformer_layer(p[f"block_{layer}/band"], h, cfg)
            h = h.view(B, T, bands, D)
    out = {}
    with tracing.span("roformer.mask"):
        hn = rms_norm(h, p["final_norm"]["gamma"]).to(compute_dtype(cfg))
        hn = hn.view(B * T, bands, D).transpose(0, 1)          # [F, M, D]
        masks = {s: mask_estimate(p, cfg, s, hn)
                 for s in predicted_sources(cfg)}
    with tracing.span("roformer.istft"):
        for s, m in masks.items():
            m = torch.view_as_complex(m.view(B, T, K, C, 2))
            y = istft_centered(spec * m.permute(0, 3, 1, 2), n_fft, hop, N)
            out[s] = y.transpose(1, 2).contiguous()
    return out


def apply_bs_roformer(params: Tree, cfg: Config,
                      x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The forward from the flat parameter dict (``prepare_params`` on
    every call: the engine prepares once, ``infer/engine.py``)."""
    return forward(prepare_params(params, cfg), cfg, x)
