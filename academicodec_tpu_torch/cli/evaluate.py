"""Objective evaluation CLI over reference-vs-degraded wav directories.

The port of ``academicodec_tpu/cli/evaluate.py``: its flags, stdout lines
and JSON (NaN written as null, with the count of skipped files per
metric), plus ``--device`` (the card unless ``cpu`` is asked for), which
only the mel distance uses; SI-SNR, STOI and PESQ run on the host.
Reference counterpart: evaluation_metric/calculate_voc_obj_metrics/
(compute_pesq.py, compute_stoi.py, compute_metrics.sh), with its stage
off-by-one fixed: every requested metric runs.

    python -m academicodec_tpu_torch.cli.evaluate --ref_dir wavs/ --deg_dir out/ \\
        --sr 24000 --estoi --json_out metrics.json
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np

from academicodec_tpu_torch.data.wavio import read_wav
from academicodec_tpu_torch.eval.metrics import evaluate_pair
from academicodec_tpu_torch.models.soundstream import resolve_device


def _json_safe(x):
    """NaN (a skipped metric) -> null: bare NaN tokens are not valid JSON."""
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_json_safe(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None):
    p = argparse.ArgumentParser("evaluate")
    p.add_argument("--ref_dir", type=str, required=True)
    p.add_argument("--deg_dir", type=str, required=True)
    p.add_argument("--sr", type=int, default=24000)
    p.add_argument("--json_out", type=str, default=None)
    p.add_argument("--estoi", action="store_true", help="also report extended STOI")
    p.add_argument("--strict", action="store_true",
                   help="require the external ITU cross-check packages "
                        "(pesq, pystoi) and abort loudly when they are "
                        "unavailable or fail, instead of silently reporting "
                        "native-only scores. Native PESQ/STOI here track "
                        "the ITU implementations but are not bit-exact "
                        "(eval/pesq.py fidelity notes); use --strict "
                        "whenever externally comparable numbers are needed")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the mel distance; the card unless cpu is asked for")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.strict:
        missing = []
        for pkg in ("pesq", "pystoi"):
            try:
                __import__(pkg)
            except ImportError:
                missing.append(pkg)
        if missing:
            raise SystemExit(
                f"--strict: external cross-check package(s) unavailable: "
                f"{', '.join(missing)}. Install them or drop --strict "
                f"(native-only scores, not externally validated)."
            )

    names = sorted(f for f in os.listdir(args.deg_dir) if f.endswith(".wav"))
    rows = []
    for name in names:
        ref_path = os.path.join(args.ref_dir, name)
        if not os.path.exists(ref_path):
            continue
        ref, _ = read_wav(ref_path, sr=args.sr)
        deg, _ = read_wav(os.path.join(args.deg_dir, name), sr=args.sr)
        rows.append(evaluate_pair(deg, ref, args.sr, estoi=args.estoi, strict=args.strict, device=device))
    if not rows:
        raise SystemExit("no overlapping wav files found")
    keys = sorted({k for r in rows for k in r})  # a metric may be absent in row 0
    # skipped rows are NaN (evaluate_pair): average the rest and disclose how
    # many files each mean excludes
    mean, skipped = {}, {}
    for k in keys:
        vals = np.array([r[k] for r in rows if k in r], dtype=np.float64)
        mean[k] = float(np.nanmean(vals)) if np.isfinite(vals).any() else float("nan")
        skipped[k] = int(np.isnan(vals).sum())
    for k, v in mean.items():
        note = f"  (skipped {skipped[k]}/{len(rows)} files)" if skipped[k] else ""
        print(f"{k}: {v:.4f}{note}")
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(_json_safe({"mean": mean, "skipped": skipped, "per_file": rows}), fh, indent=2)


if __name__ == "__main__":
    main()
