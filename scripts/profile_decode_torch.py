"""Where the time of one semantic decode goes, on an NVIDIA GPU.

    python scripts/profile_decode_torch.py

Builds the port's ``Wav2VecBertDecoder`` (random weights, seed 0, the
defaults: bf16 AR and fine stages, sampled, 1024 new tokens), warms it up,
then decodes 8 sources of 250 semantic_m ids (the ``chip_smoke.py`` 4c
input) once under
``torch.profiler``, stage by stage: the AR loop (GPT prefill + decode
steps), Bark-fine, and the EnCodec decoder. For each stage it prints the
wall time, the device busy time (the sum of the kernels that started in
it) and so the device's idle share, then the kernels that took the most
device time overall. Needs a CUDA device; imports no JAX.
"""

import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audiotoken_tpu_torch import Wav2VecBertDecoder  # noqa: E402


BATCH, IDS = 8, 250


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs on an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    dec = Wav2VecBertDecoder(weights="random", seed=0, device=dev)
    sources = [np.random.default_rng(100 + i).integers(0, 2048, IDS) for i in range(BATCH)]
    dec.max_new_tokens = 64
    dec.decode_batch(sources, seed=1)  # warm-up
    dec.max_new_tokens = 1024
    torch.cuda.synchronize()

    walls = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in (
            ("ar", lambda: dec._ar_stage(sources, 0)),
            ("fine", lambda: dec._fine_stage(rows, 0)[0]),
            ("encodec", lambda: dec.acoustic_decoder.forward_codes(fine)),
        ):
            t0 = time.perf_counter()
            with record_function(f"stage_{name}"):
                out = fn()
                torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            if name == "ar":
                rows = out
            elif name == "fine":
                fine = out

    events = prof.events()
    ranges = {e.name[len("stage_"):]: (e.time_range.start, e.time_range.end)
              for e in events if e.name.startswith("stage_") and e.device_type.name == "CPU"}
    # device-side kernels; the stage ranges appear on the device side too
    kernels = [e for e in events
               if e.device_type.name == "CUDA" and not e.name.startswith("stage_")]
    total = sum(walls.values())
    audio_s = sum(r.shape[1] for r in rows) * 320 / 24_000
    print(f"{torch.cuda.get_device_name(0)}; batch {BATCH} x {IDS} ids; "
          f"{audio_s:.2f} s of audio in {total:.3f} s (real-time factor {audio_s / total:.2f})")
    for name, (t0, t1) in ranges.items():
        busy = sum(k.time_range.end - k.time_range.start for k in kernels
                   if t0 <= k.time_range.start < t1) / 1e6
        print(f"  {name:8s} wall {walls[name]:.3f} s ({100 * walls[name] / total:.1f} %), "
              f"device busy {busy:.3f} s, idle {100 * (1 - busy / walls[name]):.1f} %")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=15))


if __name__ == "__main__":
    main()
