"""``rows`` rows of int16 PCM at the configuration's sample rate, ``seconds``
wide (``min_seconds`` to ``seconds`` long, zero past a row's length): a
voiced source (a glottal-like harmonic series on a gliding f0 of 90-250 Hz)
shaped by two moving formants, syllable envelopes of 3-5 Hz, pauses, and
unvoiced noise between the syllables; each row peaks at half of full
scale, over a white noise floor 60 dB below full scale.

-> (int16 [rows, samples], each row's length in samples)."""

import math

import torch

from portbench.synth import row_lengths


def make(mix: dict, cfg: dict, g, device):
    rows, sr = int(mix["rows"]), int(cfg["sampling_rate"])
    samples = int(round(mix["seconds"] * sr))
    lengths = row_lengths(rows, int(round(mix.get("min_seconds", mix["seconds"]) * sr)),
                          samples, g, device)

    def u(lo, hi):  # one draw a row, [rows, 1]
        return lo + (hi - lo) * torch.rand((rows, 1), generator=g, device=device)

    t = torch.arange(samples, device=device, dtype=torch.float64)[None, :] / sr
    valid = torch.arange(samples, device=device)[None, :] < torch.tensor(lengths, device=device)[:, None]
    two_pi = 2 * math.pi
    f0 = u(90.0, 250.0) * (1 + 0.15 * torch.sin(two_pi * u(0.2, 0.7) * t + u(0, two_pi))
                           + 0.05 * torch.sin(two_pi * u(2.0, 5.0) * t + u(0, two_pi)))
    phase = torch.remainder(two_pi * torch.cumsum(f0, dim=1) / sr, two_pi)
    f1 = u(300.0, 900.0) * (1 + 0.2 * torch.sin(two_pi * u(1.0, 4.0) * t + u(0, two_pi)))
    f2 = u(900.0, 2500.0) * (1 + 0.15 * torch.sin(two_pi * u(1.0, 4.0) * t + u(0, two_pi)))
    voiced = torch.zeros_like(t.expand(rows, -1))
    for k in range(1, 41):
        fk = k * f0
        w = (1.0 / k) * (1 + 4 * torch.exp(-((fk - f1) / 120.0) ** 2)
                         + 2.5 * torch.exp(-((fk - f2) / 200.0) ** 2))
        voiced += torch.where(fk < 0.45 * sr, w, torch.zeros_like(w)) * torch.sin(k * phase)
    syllable = torch.clamp(torch.sin(two_pi * u(3.0, 5.0) * t + u(0, two_pi)), min=0.0) ** 0.5
    speaking = torch.sigmoid(8 * torch.sin(two_pi * u(0.1, 0.25) * t + u(0, two_pi)))
    noise = torch.randn((rows, samples), generator=g, device=device, dtype=torch.float64)
    x = torch.where(valid, speaking * (syllable * voiced + 0.15 * (1 - syllable) * noise), 0.0)
    x = x / x.abs().amax(dim=1, keepdim=True).clamp_min(1e-9) * 0.5
    # a recording's noise floor, -60 dB of full scale: no band is digital silence
    x = x + 1e-3 * torch.randn((rows, samples), generator=g, device=device, dtype=torch.float64)
    x = torch.where(valid, x, 0.0)
    return torch.round(x * 32767).to(torch.int16).cpu().numpy(), lengths
