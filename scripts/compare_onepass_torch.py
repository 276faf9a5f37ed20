"""The one-pass attention kernel (K4 and K5's f32 path at
``precision="default"``, ``csrc/flash_attention_tf32.cu``) at chip_smoke
3g's shapes, each held against its TF32 twin and timed beside the one-pass
kernel of another checkout, in turns, in one process on one card.

    python scripts/compare_onepass_torch.py [--other DIR ...] [--reps 20] [--rounds 2]

Each DIR is an unpacked checkout of another commit, for example the parent's:
``mkdir -p _parent && git archive HEAD | tar -x -C _parent``. Its kernels
are built by its own ``ops/_build.py`` in a subprocess, and its library is
called through ctypes with the same C signatures (the entry points
``flash_attention_relkey_f32_1pass`` and ``flash_attention_plain_f32_1pass``).
Each round times the others, this tree twice, then the others in reverse
order, each ``device_ms`` of ``--reps`` calls. Without ``--other`` only
this tree's kernel runs. Prints the card's name and power limit, and the registers,
shared memory and spill that ``ptxas -v`` gave this tree's kernel.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from audiotoken_tpu_torch.ops import _build  # noqa: E402
from audiotoken_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_plain,
    flash_attention_relkey,
    flash_attention_relkey_plain,
    noncausal_attention_plain,
)
from chip_smoke import ONEPASS_SHARE, bound, device_ms  # noqa: E402

ENTRIES = ("flash_attention_relkey_f32_1pass", "flash_attention_plain_f32_1pass")


def other_library(root: Path) -> ctypes.CDLL:
    """The kernels' library of the checkout at ``root``, built there by its
    own builder in a subprocess (the two packages share a name)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from audiotoken_tpu_torch.ops import _build; _build.library(); "
            "print(_build._library_path())")
    so = subprocess.run([sys.executable, "-c", code, str(root)], check=True,
                        capture_output=True, text=True).stdout.strip().splitlines()[-1]
    lib = ctypes.CDLL(so)
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = [*_build.SIGNATURES[name], ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def call_other(lib, name, *args):
    stream = torch.cuda.current_stream().cuda_stream
    cargs = [None if a is None else a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    err = getattr(lib, name)(*cargs, stream)
    if err:
        raise RuntimeError(f"{name} (other checkout): CUDA error {err}")


def cases(dev):
    """chip_smoke 3g's inputs: (name, this tree's call, the other's call on
    its library, the TF32 twin, FLOPs)."""
    rng = np.random.default_rng(7)

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    def masked(B, T):
        mask = torch.ones((B, T), device=dev)
        mask[1, T - 377:] = 0.0
        mask[5, T // 2:] = 0.0
        return mask

    q, k, v, E, mask = (t((8, 16, 1500, 64), 0.3), t((8, 16, 1500, 64), 0.3),
                        t((8, 16, 1500, 64), 1.0), t((73, 64), 0.02), masked(8, 1500))
    q2, k2, v2, mask2 = (t((8, 12, 1499, 64), 0.3), t((8, 12, 1499, 64), 0.3),
                         t((8, 12, 1499, 64), 1.0), masked(8, 1499))
    q3, k3, v3 = t((8, 16, 1024, 64), 0.125), t((8, 16, 1024, 64), 1.0), t((8, 16, 1024, 64), 1.0)

    def relkey(q, k, v, E, mask):
        B, H, T, _ = q.shape
        P = 0 if E is None else E.shape[0]

        def other(lib, out):
            call_other(lib, ENTRIES[0], q, k, v, E, mask, out, B * H, H, T, P, 64)
        return (lambda: flash_attention_relkey(q, k, v, E, mask, precision="default"), other,
                lambda: flash_attention_relkey_plain(q, k, v, E, mask, tf32=True),
                (4 * T * T + 2 * T * P) * 64 * B * H, q)

    def plain(lib, out):
        call_other(lib, ENTRIES[1], q3, k3, v3, out, 8 * 16, 1024)

    return [
        ("rel + mask [8, 16, 1500, 64]", *relkey(q, k, v, E, mask)),
        ("mask only [8, 12, 1499, 64]", *relkey(q2, k2, v2, None, mask2)),
        ("K5 f32 [8, 16, 1024, 64]",
         lambda: flash_attention_plain(q3, k3, v3, precision="default"), plain,
         lambda: noncausal_attention_plain(q3, k3, v3, tf32=True),
         4 * 1024 * 1024 * 64 * 8 * 16, q3),
    ]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, nargs="*", default=[],
                    help="unpacked checkouts to time beside this one")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this comparison runs on an NVIDIA GPU")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    _build.library()
    log = _build.build_log().splitlines()
    for i, line in enumerate(log):
        if "attention_tf32_kernel" in line and "Compiling entry" in line:
            print(line.strip(), *(s.strip() for s in log[i + 1:i + 4]), sep="\n  ")
        if "attention_tf32_kernel" in line and "Performance Loss" in line:
            print(line.strip()[:200])
    libs = {str(d): other_library(d) for d in args.other}
    failures = []
    for name, new, other, twin, flops, like in cases(dev):
        ref = twin()
        gate = ONEPASS_SHARE * ref.abs().max().item()
        err = (new() - ref).abs().max().item()
        line = f"{name}: this {err:.3e}"
        ok = err <= gate
        out = torch.empty_like(like)
        for who, lib in libs.items():
            other(lib, out)
            line += f", {who} {(out - ref).abs().max().item():.3e}"
        print(line + f" from the TF32 twin (gate {gate:.3e})", flush=True)
        if not ok:
            failures.append(name)
        del ref
        b = bound(flops, 4 * like.numel() * 4, "tf32")["bound_ms"]
        times = {who: [] for who in ["this", *libs]}
        order = [*libs, "this", "this", *reversed(libs)]
        for _ in range(args.rounds):
            for who in order:
                fn = new if who == "this" else (lambda lib=libs[who]: other(lib, out))
                times[who].append(device_ms(fn, n=args.reps))
        for who, ts in times.items():
            if ts:
                print(f"  {who}: " + " ".join(f"{x:.4f}" for x in ts)
                      + f" ms; best {min(ts):.4f} ms, {100 * b / min(ts):.1f} % of the bound "
                      f"{b:.4f} ms", flush=True)
    if failures:
        raise SystemExit(f"outside the gate: {failures}")


if __name__ == "__main__":
    main()
