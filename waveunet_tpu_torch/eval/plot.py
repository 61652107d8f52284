"""Paper figures: SDR violin plot and spectrogram rendering.

The port's counterpart of ``waveunet_tpu/eval/plot.py`` (the reference's
``Plot.py:11-60``), saving to files with matplotlib's Agg backend:
  * ``draw_violin_sdr``: violin plot of framewise SDR per source from a
    folder of per-track evaluation JSONs;
  * ``draw_spectrogram``: log-magnitude STFT image of a WAV file, through
    the port's ``ops/stft.py``.
matplotlib is imported when a figure is drawn, not with this module: a
machine without it imports the package and fails only when asked for a
figure, with a message that says so.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from waveunet_tpu_torch.device import DeviceLike, resolve_device
from waveunet_tpu_torch.eval.aggregate import compute_mean_metrics


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("drawing figures needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def draw_violin_sdr(json_folder: str, out_path: str = "sdr_violin.pdf",
                    names=None):
    """Violin plot of the segment-wise SDR distributions per source, labelled
    with the JSONs' own target names unless ``names`` overrides them."""
    data, json_names = compute_mean_metrics(json_folder,
                                            compute_averages=False,
                                            metric="SDR", return_names=True)
    data = [d[~np.isnan(d)] for d in data]
    if not data:
        raise ValueError(f"no evaluation JSONs in {json_folder}")
    if names is None:
        names = [n.capitalize() for n in json_names]
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.violinplot(data, showmedians=True)
    ax.set_xticks(np.arange(1, len(data) + 1))
    ax.set_xticklabels(list(names)[:len(data)])
    ax.set_ylabel("SDR (dB)")
    ax.yaxis.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def draw_spectrogram(wav_path: str, out_path: Optional[str] = None,
                     frame_len: int = 512, hop: int = 256,
                     device: DeviceLike = None):
    """Log-magnitude spectrogram figure of a WAV file; the STFT runs on the
    card unless ``device="cpu"``."""
    import torch

    from waveunet_tpu_torch.data.audio_io import load
    from waveunet_tpu_torch.ops.stft import stft

    dev = resolve_device(device)
    plt = _pyplot()
    audio, sr = load(wav_path, sr=None, mono=True)
    x = torch.from_numpy(audio[:, 0]).to(dev)[None]
    spec = stft(x, frame_len, hop).abs()[0].cpu().numpy()
    fig, ax = plt.subplots(figsize=(8, 4))
    eps = 1e-8
    img = 20 * np.log10(spec.T + eps)
    ax.imshow(img, origin="lower", aspect="auto",
              extent=[0, audio.shape[0] / sr, 0, sr / 2 / 1000],
              cmap="magma", vmin=img.max() - 90, vmax=img.max())
    ax.set_xlabel("time (s)")
    ax.set_ylabel("frequency (kHz)")
    fig.tight_layout()
    out_path = out_path or os.path.splitext(wav_path)[0] + "_spec.png"
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
